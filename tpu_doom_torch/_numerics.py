"""Numeric helpers that reproduce JAX/XLA semantics in PyTorch.

* `jnp.mod` on floats is `torch.remainder` bit for bit (fmod, then add
  the divisor when the signs differ); on ints both are floor-mod.
* XLA's float -> int32 conversion saturates and maps NaN to 0, where
  PyTorch on the CPU yields INT_MIN for NaN, +-inf and out-of-range
  values. `to_i32` reproduces XLA's rule.
* Python scalars in JAX expressions are weakly typed: they round to f32
  before the op. `f32` rounds a Python float the same way, for scalar
  arithmetic done on the host.
* PyTorch divides by a host scalar as a multiplication by its
  reciprocal on CUDA, and computes `scalar / tensor` as the tensor's
  reciprocal times the scalar everywhere: two roundings where JAX and
  the kernels round once. `div` and `rdiv` divide by, and divide a
  scalar by, a tensor with one rounding.
* CUDA's f32 cos/sin and the CPU's differ by an ulp on some angles.
  `cos_sin` computes both in float64 and rounds once to float32, which
  gives the same bits on either device (the camera basis uses it).
"""

from __future__ import annotations

import numpy as np
import torch

# Largest f32 below 2**31; clamping to it keeps the int32 cast in range.
_I32_MAX_F = float(np.nextafter(np.float32(2.0**31), np.float32(0.0)))


def f32(x) -> float:
    """Round a Python number to float32 (returned as a Python float)."""
    return float(np.float32(x))


def to_i32(x: torch.Tensor) -> torch.Tensor:
    """Saturating float -> int32 truncation with NaN -> 0 (XLA's rule)."""
    x = torch.nan_to_num(x, nan=0.0, posinf=_I32_MAX_F, neginf=-(2.0**31))
    return x.clamp(-(2.0**31), _I32_MAX_F).to(torch.int32)


_SCALARS: dict = {}


def _scalar(s: float, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """A 0-d tensor holding `s`, made once per (value, dtype, device).
    Never inside a CUDA graph capture, which would only record its fill:
    the capture's warm-up tick makes every one the tick uses."""
    key = (s, dtype, device)
    t = _SCALARS.get(key)
    if t is None:
        if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                f"_numerics: the device constant {s!r} ({dtype}) was first asked for"
                " inside a CUDA graph capture; run the captured work once eagerly first")
        t = _SCALARS[key] = torch.full((), s, dtype=dtype, device=device)
    return t


def div(x: torch.Tensor, s: float) -> torch.Tensor:
    """x / s rounded once, as JAX divides by a weak-typed scalar. PyTorch
    on CUDA turns division by a host scalar into a multiplication by its
    reciprocal (two roundings); a device scalar keeps the true division.
    The scalars are config constants, so each is cached on its device."""
    return x / _scalar(s, x.dtype, x.device)


def rdiv(s: float, x: torch.Tensor) -> torch.Tensor:
    """s / x rounded once, as JAX divides a weak-typed scalar by an
    array (PyTorch's `s / x` is `x.reciprocal() * s`)."""
    return _scalar(s, x.dtype, x.device) / x


def cos_sin(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(cos x, sin x) of an f32 tensor, computed in float64 and rounded
    once to float32: the same bits on the card and on the CPU."""
    d = x.to(torch.float64)
    return torch.cos(d).to(torch.float32), torch.sin(d).to(torch.float32)
