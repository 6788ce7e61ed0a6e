"""The `texstress8` leg of `python -m tpu_doom_torch.bench --verify` on the
CPU (the kernels' plain versions), against
tests/golden/verify_texstress8_ref.npz: the JAX package's portal_jnp
render of the 8 :texstress: states of verify_texstress_ref.npz at
portal_compact_crossings=8, where envs with more than 8 live crossings,
and env 1 (pitched), take the triangle path. The golden holds that
render run op by op (`idx`/`cov`, what the port is held to) and jitted
stage by stage (`idx_jit`/`cov_jit`), which differ in a floor strip of
envs 3 and 4 (ROADMAP C).

Per env, each backend within the px counts measured on the CPU
(PER_ENV_CEILING) and cov equal; the leg's verdict, and over the leg the
other legs' ceiling (16 px and 16 cov, bench.py:88-90) against the golden
and between the two backends. ~1 min.
"""

import numpy as np
import pytest
import torch

from tpu_doom_torch import bench
from tpu_doom_torch.sim.state import SimState

# Largest px per env against the op-by-op golden, as measured on the CPU.
PER_ENV_CEILING = {
    "portal": [0, 1, 0, 2, 1, 0, 2, 0],
    "portal_jnp": [0, 1, 0, 0, 0, 0, 0, 0],
}
# The golden's jitted render against its op-by-op one, px per env.
JIT_GAP = [1, 4, 0, 253, 382, 3, 25, 1]


@pytest.fixture(scope="module")
def leg():
    """({backend: (idx, cov)}, golden) of the texstress8 leg's states."""
    ref = bench._golden("verify_texstress_ref.npz")
    golden = bench._golden("verify_texstress8_ref.npz")
    state = SimState(*(torch.as_tensor(ref[k]) for k in SimState._fields))
    frames = bench._Verifier(torch.device("cpu"))._render(
        ":texstress:", lambda sim: state, 320, 200, portal_compact_crossings=8)
    return frames, golden


@pytest.mark.parametrize("backend", sorted(PER_ENV_CEILING))
def test_texstress8_frames_match_op_by_op_golden(leg, backend):
    frames, golden = leg
    idx, cov = frames[backend]
    assert idx.shape == golden["idx"].shape == (8, 200, 320)
    px = (idx != golden["idx"]).sum(axis=(1, 2))
    assert (px <= PER_ENV_CEILING[backend]).all(), px.tolist()
    assert np.array_equal(cov, golden["cov"])


def test_texstress8_leg_passes(leg):
    """The leg's verdict (per pose within TEXSTRESS8_POSE_CEILING, the
    card's reading), and on the CPU the other legs' rule too: summed over
    the leg within 16 px."""
    frames, golden = leg
    res = bench._leg(frames, golden["idx"], golden["cov"], "pose",
                     golden_ceiling=bench.TEXSTRESS8_POSE_CEILING)
    assert res["pass"], res
    res = bench._leg(frames, golden["idx"], golden["cov"], "leg")
    assert res["pass"] and res["golden_px"] <= bench.VERIFY_CEILING, res


def test_texstress8_golden_records_the_jit_gap():
    """The two JAX renders in the golden differ where ROADMAP C says;
    the port sits with the op-by-op one."""
    golden = bench._golden("verify_texstress8_ref.npz")
    gap = (golden["idx_jit"] != golden["idx"]).sum(axis=(1, 2))
    assert gap.tolist() == JIT_GAP
    assert np.array_equal(golden["cov_jit"], golden["cov"])
