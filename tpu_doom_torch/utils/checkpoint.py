"""Checkpoint / resume: the whole sim state is one NamedTuple of tensors.

Port of the JAX package's `utils/checkpoint.py`, with its `.npz` layout:
`state_<field>` for each SimState field, `meta_<key>` for each metadata
value. A file written by either package loads in the other, bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from ..sim.state import SimState, state_to_numpy


def save_state(path: str, state: SimState, **extra):
    """Write a SimState (+ optional metadata scalars) to an .npz file."""
    arrays = {f"state_{k}": v for k, v in state_to_numpy(state).items()}
    for k, v in extra.items():
        arrays[f"meta_{k}"] = np.asarray(v)
    np.savez_compressed(path, **arrays)


def load_state(path: str, device="cuda") -> tuple[SimState, dict]:
    """Read back (SimState on `device`, metadata dict): the card unless
    the caller asks for the CPU."""
    from ..models.doom_sim import checked_device

    dev = checked_device(device)
    with np.load(path) as data:
        fields = {
            k[len("state_"):]: torch.as_tensor(data[k], device=dev)
            for k in data.files
            if k.startswith("state_")
        }
        meta = {
            k[len("meta_"):]: data[k] for k in data.files if k.startswith("meta_")
        }
    return SimState(**fields), meta
