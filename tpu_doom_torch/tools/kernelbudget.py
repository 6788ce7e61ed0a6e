"""B11: where kernel B2's time goes, stage by stage, on the card.

    python -m tpu_doom_torch.tools.kernelbudget [variant ...] [--device cpu]

Variants: prod full no_classify no_alpha no_tex no_hole no_cmap
no_lookups no_shade_math no_flatten (default: all).
Environment: BENCH_BATCH (256), BENCH_W (320), BENCH_H (200), BENCH_REPS
(20 timed runs of BACK_TO_BACK launches).

Replaces tools/kernelbudget.py (`_ablated_call`, :201, kernel
`_ablated_kernel`), which timed a measurement copy of the TPU's fused
classify + shade kernel with stages switched off one at a time. That copy
drifted from its kernel; here the stages are switched off in B2 itself:
csrc/render_portal.cu is a template over a mask of stages, production
launches <0>, and `render_portal_ablated` launches the instantiation of
one of the masks below (B2's global-table mode). Each stage, as the TPU
tool defines it:
  classify    every classified channel is 0: kind 0, nothing covered
              (the walk alone is off: every pixel is still shaded);
  alpha       masked-family records hit without the texel alpha test;
  tex         the texel v1 = 128;
  hole        no holes;
  cmap        no colormap: v2 = v1;
  lookups     tex + hole + cmap;
  shade_math  lin = clip(trunc(cbase), 0, S1 * 128 - 1), crow =
              clip(trunc(light), 0, n_rows - 1); kind, sky, covered stay.
`flatten` switched off the TPU kernel's row -> lane relayout; B2 needs no
relayout, so `no_flatten` has no counterpart. `full` is the production
kernel launched through the ablation entry; `prod` is
`ops.render_portal_fused`.

Inputs, as the TPU tool's: `:test:` at 320x200 x 256 envs with
clip_substeps=4, reset, yaws from default_rng(0).uniform(0, 6.28, B), the
port's own walk and sky (`render.portal.fused_inputs`). Each variant is
timed as BENCH_REPS runs of BACK_TO_BACK launches between two CUDA events
on the card (single calls on the host clock on the CPU), after 2
warm-ups; the median run over its launches is printed as ms per batch,
then each stage's share (full - variant) / full.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from .._build import check, load
from .._numerics import f32, to_i32
from ..ops.raster import (
    NCH,
    RECORDS_PER_CROSSING,
    _classify,
    _global_texel,
    _ndc_rows,
    _shade_address,
    _shade_out,
    check_sky,
    sky_gather,
)
from . import device_label

# Variant -> the stages it switches off (the TPU tool's `ABL`, :334-339).
ABLATIONS = {
    "full": (),
    "no_classify": ("classify",),
    "no_alpha": ("alpha",),
    "no_tex": ("tex",),
    "no_hole": ("hole",),
    "no_cmap": ("cmap",),
    "no_lookups": ("tex", "hole", "cmap"),
    "no_shade_math": ("shade_math",),
}
# Stage -> its bit in the kernel's mask (csrc/render_portal.cu kNo*).
STAGE_BITS = dict(classify=1, alpha=2, tex=4, hole=8, cmap=16, shade_math=32)
VARIANTS = ("prod", *ABLATIONS)
BACK_TO_BACK = 10  # launches per pair of events
NOT_APPLICABLE = {"no_flatten": "not applicable on this card"}


def _stages(ablate) -> frozenset:
    """The ablation as a set of stages; only the masks the kernel
    instantiates (the ABLATIONS values) are accepted."""
    stages = frozenset(ablate)
    if stages not in {frozenset(v) for v in ABLATIONS.values()}:
        raise ValueError(f"render_portal_ablated: no variant switches off {sorted(stages)}")
    return stages


def render_portal_ablated_ref(records, words, cam, hc: int, dxz, sky_x, sky_y,
                              sky_tex, tex, hole_bytes, cmap_i8, height: int,
                              p11: float, n_rows: int, shear=None, ablate=()):
    """Plain version of B2 with the stages of `ablate` switched off, in
    the global-table mode (tex (S1, 128) s8, hole_bytes (Sh, 128) s8 or
    None; other arguments as `ops.raster.render_portal_fused_ref`, which
    this equals with `ablate=()`). Returns (palette index (B, H, W) u8,
    covered (B, H, W) bool)."""
    stages = _stages(ablate)
    if tex.dim() != 2:
        raise ValueError("render_portal_ablated: the global-table mode only")
    B, _, _, W = records.shape
    dev = records.device
    p11 = f32(p11)
    S1 = tex.shape[0]
    if shear is None:
        shear = torch.zeros((B,), dtype=torch.float32, device=dev)
    y, ndc0 = _ndc_rows(height, dev)
    ndc_y = ndc0 + shear[:, None, None]  # (B, H, 1)
    cam_x, cam_y, cam_z = (cam[:, i, None, None] for i in range(3))
    if "classify" in stages:
        ch = torch.zeros((B, 11, height, W), dtype=torch.float32, device=dev)
    else:
        ch = _classify(records, words, cam_y, hc, ndc_y, y, p11, done_on_kind=False,
                       alpha_test="alpha" not in stages)
    if "shade_math" in stages:
        kind = ch[:, 0]
        lin = to_i32(ch[:, 4]).clamp(0, S1 * 128 - 1)
        crow = to_i32(ch[:, 5]).clamp(0, n_rows - 1)
        covered0, is_sky = kind != 0.0, kind == 3.0
    else:
        lin, crow, covered0, is_sky = _shade_address(
            ch, ndc_y, dxz[:, 0, None, :], dxz[:, 1, None, :], cam_x, cam_y, cam_z,
            p11, n_rows, S1)
    v1, hole = _global_texel(tex, None if "hole" in stages else hole_bytes, lin)
    if "tex" in stages:
        v1 = torch.full_like(v1, 128)
    idx, cov = _shade_out(v1, hole, crow, covered0, is_sky,
                          sky_gather(sky_x, sky_y, sky_tex),
                          None if "cmap" in stages else cmap_i8)
    return idx.to(torch.uint8), cov > 0.5


def render_portal_ablated(records, words, cam, hc: int, dxz, sky_x, sky_y, sky_tex,
                          tex, hole_bytes, cmap_i8, height: int, p11: float,
                          n_rows: int, shear=None, ablate=()):
    """B2's ablation instantiations for CUDA tensors, the plain version
    for CPU tensors (arguments as `render_portal_ablated_ref`)."""
    stages = _stages(ablate)
    if records.device.type == "cpu":
        return render_portal_ablated_ref(
            records, words, cam, hc, dxz, sky_x, sky_y, sky_tex, tex, hole_bytes,
            cmap_i8, height, p11, n_rows, shear, stages)
    if records.device.type != "cuda":
        raise ValueError(f"render_portal_ablated: unsupported device {records.device}")
    B, R, nch, W = records.shape
    H = int(height)
    K, n_words = words.shape[1], words.shape[2]
    if (nch != NCH or R != K * RECORDS_PER_CROSSING or words.shape != (B, K, n_words, W)
            or cam.shape != (B, 3) or dxz.shape != (B, 2, W)
            or tex.dim() != 2 or tex.shape[1] != 128
            or cmap_i8.shape[1] != 128 or (hole_bytes is not None and (
                hole_bytes.shape[1] != 128 or hole_bytes.shape[0] * 1024 < tex.shape[0] * 128))):
        raise ValueError("render_portal_ablated: bad shapes (global-table mode only;"
                         " the hole table must cover the texel table)")
    check_sky(sky_x, sky_y, sky_tex, B, H, W, "render_portal_ablated")
    if (records.dtype, words.dtype, tex.dtype, cmap_i8.dtype) != (
            torch.float32, torch.int32, torch.int8, torch.int8) or (
            hole_bytes is not None and hole_bytes.dtype != torch.int8):
        raise ValueError("render_portal_ablated: bad dtypes")
    dev = records.device
    if shear is None:
        shear = torch.zeros((B,), dtype=torch.float32, device=dev)
    args = [t.contiguous() for t in (records, words, cam.float(), shear.float(),
                                     dxz.float(), sky_x, sky_y, sky_tex, tex)]
    holeless = hole_bytes is None
    hole = (torch.zeros((1, 128), dtype=torch.int8, device=dev) if holeless
            else hole_bytes.contiguous())
    cmap = cmap_i8.contiguous()
    idx = torch.empty((B, H, W), dtype=torch.uint8, device=dev)
    cov = torch.empty((B, H, W), dtype=torch.bool, device=dev)
    check(load().tdt_render_portal_ablated(
        *[t.data_ptr() for t in args], hole.data_ptr(), cmap.data_ptr(),
        idx.data_ptr(), cov.data_ptr(), B, R, W, H, n_words, int(hc),
        sky_tex.shape[0], sky_tex.shape[1], tex.shape[0], int(holeless), f32(p11),
        int(n_rows), sum(STAGE_BITS[s] for s in stages),
        0, torch.cuda.current_stream(dev).cuda_stream,
    ), "render_portal_ablated")
    render_portal_ablated.launches += 1
    return idx, cov


render_portal_ablated.launches = 0


@torch.no_grad()
def budget_inputs(batch: int, width: int, height: int, device):
    """B2's arguments and keyword arguments on the TPU tool's inputs."""
    from ..models import DoomSim
    from ..render.portal import fused_inputs
    from ..utils.config import GameConfig, PlayerConfig

    cfg = GameConfig(wad_file=":test:", width=width, height=height, batch_size=batch,
                     raster_backend="portal", player=PlayerConfig(clip_substeps=4))
    sim = DoomSim(cfg, device)
    yaw = np.random.default_rng(0).uniform(0, 6.28, batch).astype(np.float32)
    state = sim.reset(batch)._replace(yaw=torch.as_tensor(yaw, device=sim.device))
    args, kw, _ = fused_inputs(sim.portal_scene(), sim.scene, cfg, width, height, state)
    return args, kw


def variant_fn(name: str, args, kw):
    """A call of one variant on B2's arguments."""
    if name == "prod":
        from ..ops import render_portal_fused

        return lambda: render_portal_fused(*args, **kw)
    return lambda: render_portal_ablated(*args, **kw, ablate=ABLATIONS[name])


def median_ms(fn, device, runs: int, per_run: int = BACK_TO_BACK,
              warmup: int = 2) -> float:
    """Median over `runs` runs of `per_run` calls back to back of the ms
    per call, after `warmup` calls: CUDA events around each run on the
    card, the host clock on the CPU."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(per_run):
                fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / per_run)
        else:
            t0 = time.perf_counter()
            for _ in range(per_run):
                fn()
            times.append((time.perf_counter() - t0) * 1e3 / per_run)
    return float(np.median(times))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("variants", nargs="*", metavar="variant",
                    help=f"any of {' '.join((*VARIANTS, *NOT_APPLICABLE))}")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    names = args.variants or [*VARIANTS, *NOT_APPLICABLE]
    unknown = [n for n in names if n not in VARIANTS and n not in NOT_APPLICABLE]
    if unknown:
        ap.error(f"unknown variants {unknown}")
    batch = int(os.environ.get("BENCH_BATCH", "256"))
    width = int(os.environ.get("BENCH_W", "320"))
    height = int(os.environ.get("BENCH_H", "200"))
    reps = int(os.environ.get("BENCH_REPS", "20"))
    dev = torch.device(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    b2_args, b2_kw = budget_inputs(batch, width, height, dev)
    per_run = BACK_TO_BACK if dev.type == "cuda" else 1  # the CPU checks the tool only
    print(f"[kernelbudget] :test: {width}x{height} x {batch} envs on"
          f" {device_label(dev)}; median of {reps} runs of {per_run} calls"
          " back to back, after 2 warm-ups", flush=True)
    times = {}
    for name in names:
        if name in NOT_APPLICABLE:
            print(f"{name:>14}: {NOT_APPLICABLE[name]}", flush=True)
            continue
        times[name] = median_ms(variant_fn(name, b2_args, b2_kw), dev, reps, per_run)
        print(f"{name:>14}: {times[name]:8.4f} ms/batch (B={batch})", flush=True)
    if "full" in times:
        for name, ms in times.items():
            if name in ABLATIONS and name != "full":
                print(f"{name:>14}: share (full - variant) / full"
                      f" {(times['full'] - ms) / times['full']:+.4f}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
