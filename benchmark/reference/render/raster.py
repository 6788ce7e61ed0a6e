"""Triangle rasterizer: the exact fallback of the portal renderer.

Port of `tpu_doom/render/raster_jnp.py`: per-env vertex processing and
triangle setup (`_prepare_env`), then one of two paths:
* the kernel path: row/attribute packing (`pack_triangle_rows_full` /
  `pack_triangle_attrs`), the y-sort, the fused peel + resolve (kernel
  B3, `ops.raster.peel_resolve`) and the channel shading
  (`_shade_from_channels`);
* the "jnp" reference path: the K-layer peel (kernel B9,
  `ops.raster.depth_peel`), the first layer whose texel survives
  (`_winner_from_layers`) and the shade (`_shade`).
The env batch is written out: per-vertex tables are (B, N, ...),
per-triangle ones (B, T, ...).
"""

from __future__ import annotations

import math

import torch

from .._numerics import div, f32, rdiv, to_i32
from ..ops.raster import depth_peel, pack_triangle_rows, peel_resolve
from ..sim.lights import light_table_u8
from .camera import camera_matrices

PASS_FLAT, PASS_WALL, PASS_DECOR, PASS_SKY = 0, 1, 2, 3
ANIM_FPS = 8.0 / 35.0  # assets/shaders/static.vert:22
DIST_SCALE_STATIC = 0.9  # static.frag:17
DIST_SCALE_SPRITE = 1.0  # sprite.frag:17
LIGHT_SCALE = 2.0
ATTR_COLS = 16


RASTER_BACKENDS = ("portal", "portal_jnp", "auto", "jnp")


def check_raster_backend(backend: str) -> str:
    """The renderer a config names; kernel or plain version is chosen by
    the tensors' device, never by the name:
    * "portal": the column walk, then the fused classify + shade (B2);
      envs it cannot take fall back to "auto"'s triangle path;
    * "portal_jnp": the JAX package's reference configuration of the same
      renderer: the walk, the classify (B7), then the shade (B8) on the
      global compact texel table; envs it cannot take fall back to
      "jnp"'s triangle path;
    * "auto": the triangle path through the fused peel + resolve (B3);
    * "jnp": the JAX package's reference triangle path: the K-layer peel
      (B9), the first layer whose texel survives, then the shade.
    The JAX package's other names pick a TPU kernel or interpret mode,
    which the port has no use for."""
    if backend not in RASTER_BACKENDS:
        raise ValueError(
            f"raster_backend={backend!r} names a JAX/TPU backend; the port "
            f"has {RASTER_BACKENDS} and picks kernel or plain version by "
            "the tensors' device")
    return backend


def _cross(a, b):
    return torch.stack([
        a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0],
    ], dim=-1)


def _sum3(a):
    return a[..., 0] + a[..., 1] + a[..., 2]


def anim_atlas_uv(atlas_uv, tile_size, row_step, num_frames, atlas_w, time):
    """Animation frame select with atlas row wrap (static.vert:27-40).
    Per-vertex tables (..., N, ...) broadcast against time (B, 1)."""
    nf = num_frames.to(torch.float32)
    frame = torch.floor(torch.remainder(div(time, ANIM_FPS), torch.clamp_min(nf, 1.0)))
    atlas_u = atlas_uv[..., 0] + frame * tile_size[..., 0]
    n_rows = torch.ceil(div(atlas_u + tile_size[..., 0], atlas_w)) - 1.0
    safe_ts = torch.where(tile_size[..., 0] == 0.0, 1.0, tile_size[..., 0])
    atlas_u = atlas_u + torch.remainder(atlas_w - atlas_uv[..., 0], safe_ts) * n_rows
    atlas_v = atlas_uv[..., 1] + n_rows * row_step
    animated = torch.stack([atlas_u, atlas_v], dim=-1)
    return torch.where((num_frames == 1)[..., None], atlas_uv, animated)


def pixel_grid(width, height, device):
    """(3, P) pixel-center homogeneous coords; image row j is window
    y = height - j - 0.5."""
    i = torch.arange(width, dtype=torch.float32, device=device) + 0.5
    j = torch.arange(height, dtype=torch.float32, device=device)
    py = height - j - 0.5
    px = i.repeat(height)
    pyf = py.repeat_interleave(width)
    return torch.stack([px, pyf, torch.ones_like(px)], dim=0)


def _matmul4(a, b):
    """(B, 4, 4) @ (B, 4, 4) with each sum taken in index order."""
    out = a[..., :, 0, None] * b[..., 0, None, :]
    for k in range(1, 4):
        out = out + a[..., :, k, None] * b[..., k, None, :]
    return out


def _transform(pos, pvm):
    """(B, N, 3) positions -> (B, N, 4) clip coords: pos @ pvm[:, :3].T +
    pvm[:, 3]."""
    m = pvm[:, None]  # (B, 1, 4, 4)
    return (pos[..., 0, None] * m[..., :, 0] + pos[..., 1, None] * m[..., :, 1]
            + pos[..., 2, None] * m[..., :, 2]) + m[..., :, 3]


def scene_triangles(scene):
    """Static combined triangle list, pass ids and transparency."""
    ns, nk = scene.static_pos.shape[0], scene.sky_pos.shape[0]
    tri_list = torch.cat([
        scene.flat_tris, scene.wall_tris, scene.decor_tris + ns + nk,
        scene.sky_tris + ns,
    ], dim=0).long()
    dev = tri_list.device
    counts = [scene.flat_tris.shape[0], scene.wall_tris.shape[0],
              scene.decor_tris.shape[0], scene.sky_tris.shape[0]]
    tri_pass = torch.cat([
        torch.full((n,), p, dtype=torch.int32, device=dev)
        for n, p in zip(counts, (PASS_FLAT, PASS_WALL, PASS_DECOR, PASS_SKY))
    ])
    transparent = torch.cat([
        torch.zeros((counts[0],), dtype=torch.bool, device=dev),
        scene.wall_tri_transparent.bool(),
        torch.ones((counts[2],), dtype=torch.bool, device=dev),
        torch.zeros((counts[3],), dtype=torch.bool, device=dev),
    ])
    return tri_list, tri_pass, transparent


def prepare(scene, cfg, width, height, state):
    """Vertex processing + triangle setup for every env."""
    pcfg = cfg.player
    mv, proj = camera_matrices(
        state.pos, state.yaw, state.pitch, camera_height=pcfg.camera_height,
        fovy_rad=math.radians(cfg.fov),
        aspect=(width / height) * pcfg.aspect_ratio_correction,
        near=pcfg.near, far=pcfg.far,
    )
    B = state.pos.shape[0]
    pvm = _matmul4(proj.expand(B, 4, 4), mv)
    time = state.time[:, None]
    off = state.object_offset
    lights_f = div(light_table_u8(scene, state.time).to(torch.float32), 255.0)

    flats_w = float(scene.flats_atlas.shape[1])
    walls_w = float(scene.walls_atlas_index.shape[1])

    def offset_y(pos, obj):
        dy = off[:, obj.long()]  # (B, N)
        p = pos.expand(B, -1, -1).clone()
        p[..., 1] = p[..., 1] + dy
        return p

    s_clip = _transform(offset_y(scene.static_pos, scene.static_object), pvm)
    s_tile_uv = scene.static_tile_uv + torch.stack(
        [time * scene.static_scroll, torch.zeros_like(time * scene.static_scroll)],
        dim=-1)
    s_atlas_flat = anim_atlas_uv(
        scene.static_atlas_uv, scene.static_tile_size, scene.static_row_height,
        scene.static_num_frames, flats_w, time)
    s_atlas_wall = anim_atlas_uv(
        scene.static_atlas_uv, scene.static_tile_size, scene.static_row_height,
        scene.static_num_frames, walls_w, time)

    k_clip = _transform(offset_y(scene.sky_pos, scene.sky_object), pvm)
    right = mv[:, 0, :3]  # camera right = row 0 of the modelview
    d_pos = offset_y(scene.decor_pos, scene.decor_object)
    d_pos = d_pos + right[:, None, :] * scene.decor_local_x[None, :, None]
    d_clip = _transform(d_pos, pvm)

    clip = torch.cat([s_clip, k_clip, d_clip], dim=1)
    x, y, z, w = clip.unbind(-1)
    clip = torch.stack([(x + w) * 0.5 * width, (y + w) * 0.5 * height, w, z], dim=-1)

    nk = k_clip.shape[1]
    dev = clip.device
    zeros2 = torch.zeros((B, nk, 2), dtype=torch.float32, device=dev)
    decor_uv = scene.decor_tile_uv.expand(B, -1, -1)
    decor_auv = scene.decor_atlas_uv.expand(B, -1, -1)
    tile_uv = torch.cat([s_tile_uv, zeros2, decor_uv], dim=1)
    atlas_a = torch.cat([s_atlas_flat, zeros2, decor_auv], dim=1)
    atlas_b = torch.cat([s_atlas_wall, zeros2, decor_auv], dim=1)
    tile_size = torch.cat([scene.static_tile_size, zeros2[0], scene.decor_tile_size], 0)
    light_idx = torch.cat([
        scene.static_light, torch.zeros((nk,), dtype=torch.int32, device=dev),
        scene.decor_light], 0)

    tri_list, tri_pass, transparent = scene_triangles(scene)
    v = clip[:, tri_list]  # (B, T, 3, 4)
    c = v[..., :3]
    c0, c1, c2 = c[:, :, 0], c[:, :, 1], c[:, :, 2]
    e0, e1, e2 = _cross(c1, c2), _cross(c2, c0), _cross(c0, c1)
    det = _sum3(c0 * e0)
    zc = v[..., 3]
    vz = zc[..., 0, None] * e0 + zc[..., 1, None] * e1 + zc[..., 2, None] * e2
    vs = e0 + e1 + e2
    e = torch.stack([e0, e1, e2], dim=2)
    det = torch.where(det > 0.0, det, 0.0)

    # Per-triangle window-y bounds for the kernel's chunk culling.
    w_ok = v[..., 2] > 1e-6
    yw = v[..., 1] / torch.where(w_ok, v[..., 2], 1.0)
    ymin = torch.where(w_ok, yw, float("inf")).amin(dim=2)
    ymax = torch.where(w_ok, yw, -float("inf")).amax(dim=2)
    any_bad = ~w_ok.all(dim=2)
    ymin = torch.where(any_bad, 0.0, ymin.clamp(0.0, float(height)))
    ymax = torch.where(any_bad, float(height), ymax.clamp(0.0, float(height)))
    a_, b_, w_, z_ = v.unbind(-1)
    out_left = (a_ < 0.0).all(dim=2)
    out_right = (a_ > w_ * float(width)).all(dim=2)
    out_bottom = (b_ < 0.0).all(dim=2)
    out_top = (b_ > w_ * float(height)).all(dim=2)
    out_near = (z_ < -w_).all(dim=2)
    out_far = (z_ > w_).all(dim=2)
    all_behind = (v[..., 2] <= 0.0).all(dim=2)
    all_front = w_ok.all(dim=2)
    culled = (
        (all_front & (out_left | out_right | out_bottom | out_top | out_near | out_far))
        | all_behind | (det <= 0.0)
    )
    ymin = torch.where(culled, float("inf"), ymin)
    ymax = torch.where(culled, -float("inf"), ymax)

    first = tri_list[:, 0]
    return dict(
        e=e, det=det, vz=vz, vs=vs, tri_pass=tri_pass, transparent=transparent,
        v_tile_uv_tri=tile_uv[:, tri_list],  # (B, T, 3, 2)
        v_atlas_a_tri=atlas_a[:, first], v_atlas_b_tri=atlas_b[:, first],
        v_tile_size_tri=tile_size[first], v_light_tri=light_idx[first],
        lights_f=lights_f, pvm=pvm,
        tri_ybounds=torch.stack([ymin, ymax], dim=-1),
    )


def pack_triangle_rows_full(e, det, vz, vs, tri_uv):
    """(B, T, 24) rows [e (9), zr (3), vs (3), valid, uxr (3), uyr (3),
    draw-order id, 0] (raster_pallas.py:69-92)."""
    ux, uy = tri_uv[..., 0], tri_uv[..., 1]  # (B, T, 3)
    uxr = ux[..., 0, None] * e[..., 0, :] + ux[..., 1, None] * e[..., 1, :] \
        + ux[..., 2, None] * e[..., 2, :]
    uyr = uy[..., 0, None] * e[..., 0, :] + uy[..., 1, None] * e[..., 1, :] \
        + uy[..., 2, None] * e[..., 2, :]
    T = det.shape[-1]
    orig_id = torch.arange(T, dtype=torch.float32, device=det.device).expand(det.shape)
    return torch.cat([
        pack_triangle_rows(e, det, vz, vs), uxr, uyr, orig_id[..., None],
        torch.zeros_like(det)[..., None],
    ], dim=-1)


def pack_triangle_attrs(tile_size, base_a, base_b, light_value, pass_id,
                        transparent, det):
    """Per-triangle flat scalars -> (B, T, 16) (raster_pallas.py:95-116)."""
    shape = det.shape
    cols = [
        tile_size[..., 0].expand(shape), tile_size[..., 1].expand(shape),
        base_a[..., 0], base_a[..., 1], base_b[..., 0], base_b[..., 1],
        light_value, pass_id.to(torch.float32).expand(shape),
        transparent.to(torch.float32).expand(shape), det,
    ]
    out = torch.stack(cols, dim=-1)
    pad = torch.zeros(shape + (ATTR_COLS - len(cols),), dtype=out.dtype,
                      device=out.device)
    return torch.cat([out, pad], dim=-1)


def sky_coords(scene, width, height, pvm, grid):
    """Per-pixel sky texel (x, y), (B, P) each (sky.vert / sky.frag)."""
    fwd = pvm[:, :, 2]  # (B, 4)
    v_r0 = torch.atan2(fwd[:, 0], fwd[:, 2])[:, None]
    v_r1 = (fwd[:, 1] / torch.where(fwd[:, 3] == 0.0, 1.0, fwd[:, 3]))[:, None]
    ndc_x = div(grid[0], 0.5 * width) - 1.0
    ndc_y = div(grid[1], 0.5 * height) - 1.0
    sky_u = ndc_x - div(4.0 * v_r0, f32(math.pi))
    sky_v = -ndc_y + 1.0 + v_r1
    return sky_x_texel(scene, sky_u), sky_y_texel(scene, sky_v)


def sky_x_texel(scene, sky_u):
    """Sky u -> texel column, wrapped to the sky plane's width."""
    w = scene.combo_dims[3, 1]
    return torch.remainder(to_i32(torch.floor(sky_u * w)), w)


def sky_y_texel(scene, sky_v):
    """Band-fold sky v (sky.frag) -> texel row, wrapped to the plane."""
    band = scene.tiled_band_size
    safe_band = torch.where(band == 0.0, 1.0, band)
    below = torch.abs(torch.remainder(-sky_v + safe_band, safe_band * 2.0) - safe_band)
    above = torch.abs(
        torch.remainder(sky_v - 2.0 + safe_band, safe_band * 2.0) - safe_band)
    mid = 1.0 - sky_v
    sky_v = torch.where(
        sky_v < 0.0, below,
        torch.where(sky_v >= 2.0, above, torch.where(sky_v >= 1.0, mid, sky_v)))
    h = scene.combo_dims[3, 0]
    return torch.remainder(to_i32(torch.floor(sky_v * h)), h)


def shade_from_channels(scene, width, height, ch, pvm, grid):
    """Fragment shading from the resolved channels ch (B, K, 16, P): one
    combined colormapped-atlas load per layer (raster_jnp.py:417-512)."""
    K = ch.shape[1]
    n_rows, _, hc, wc = scene.combo_atlas.shape
    combo_flat = scene.combo_atlas.reshape(-1)
    dims = scene.combo_dims
    sky_x, sky_y = sky_coords(scene, width, height, pvm, grid)
    B, P = ch.shape[0], ch.shape[-1]
    dev = ch.device
    covered = torch.zeros((B, P), dtype=torch.bool, device=dev)
    out_index = torch.zeros((B, P), dtype=torch.int32, device=dev)
    done = torch.zeros((B, P), dtype=torch.bool, device=dev)
    for k in range(K):
        c = ch[:, k]
        uvx, uvy, w = c[:, 1], c[:, 2], c[:, 3]
        tsx, tsy = c[:, 4], c[:, 5]
        bax, bay, bbx, bby = c[:, 6], c[:, 7], c[:, 8], c[:, 9]
        light_v = c[:, 10]
        p_pass = to_i32(c[:, 11])
        transp = c[:, 12] > 0.5
        has = c[:, 13] > 0.5
        is_wall = p_pass == PASS_WALL
        is_sky = p_pass == PASS_SKY
        is_flat = p_pass == PASS_FLAT
        is_decor = p_pass == PASS_DECOR
        u = torch.remainder(uvx, torch.where(tsx == 0.0, 1.0, tsx)) \
            + torch.where(is_wall, bbx, bax)
        v = torch.remainder(uvy, torch.where(tsy == 0.0, 1.0, tsy)) \
            + torch.where(is_wall, bby, bay)
        plane = p_pass.clamp(0, 3)
        wrap_h = (dims[0, 0] * is_flat + dims[1, 0] * is_wall
                  + dims[2, 0] * is_decor + dims[3, 0] * is_sky)
        wrap_w = (dims[0, 1] * is_flat + dims[1, 1] * is_wall
                  + dims[2, 1] * is_decor + dims[3, 1] * is_sky)
        x = torch.remainder(to_i32(torch.floor(u)), wrap_w.clamp_min(1))
        y = torch.remainder(to_i32(torch.floor(v)), wrap_h.clamp_min(1))
        x = torch.where(is_sky, sky_x, x)
        y = torch.where(is_sky, sky_y, y)

        dist_s = torch.clamp_max(1.0 - DIST_SCALE_STATIC / (w + DIST_SCALE_STATIC), 1.0)
        dist_d = torch.clamp_max(1.0 - DIST_SCALE_SPRITE / (w + DIST_SCALE_SPRITE), 1.0)
        light_static = light_v * LIGHT_SCALE - dist_s
        light_decor = torch.minimum(light_v, light_v * LIGHT_SCALE - dist_d)
        light = torch.where(is_decor, light_decor, light_static)
        row = to_i32(torch.floor((1.0 - light) * float(n_rows))).clamp(0, n_rows - 1)
        row = torch.where(is_sky, 0, row)

        lin = ((row * 4 + plane) * hc + y) * wc + x
        value = combo_flat[lin.long().clamp(0, combo_flat.numel() - 1)]
        index = value & 255
        hole = value >= 256
        survive = has & torch.where(transp, ~hole, True)
        win = survive & ~done
        covered = covered | win
        out_index = torch.where(win, index, out_index)
        done = done | win | ~has
    index = torch.where(covered, out_index, 0).to(torch.uint8)
    return index, covered


def peel_inputs(scene, cfg, width, height, state):
    """Kernel B3's inputs for every env: y-sorted (rows (B, T, 24),
    attrs (B, T, 16), ybounds (B, T, 2)), the pixel grid (3, P), and the
    per-env (B, 4, 4) projection-view matrices for the sky."""
    B = state.pos.shape[0]
    grid = pixel_grid(width, height, state.pos.device)
    prep = prepare(scene, cfg, width, height, state)
    rows = pack_triangle_rows_full(
        prep["e"], prep["det"], prep["vz"], prep["vs"], prep["v_tile_uv_tri"])
    lights_f = prep["lights_f"]
    light_val = torch.gather(
        lights_f, 1,
        prep["v_light_tri"].long().clamp(0, lights_f.shape[1] - 1)[None].expand(B, -1))
    attrs = pack_triangle_attrs(
        prep["v_tile_size_tri"], prep["v_atlas_a_tri"], prep["v_atlas_b_tri"],
        light_val, prep["tri_pass"], prep["transparent"], prep["det"])
    # Sort triangles by screen ymin so each chunk's y-bounds are tight
    # (original draw-order ids ride in rows column 22).
    ybounds = prep["tri_ybounds"]
    order = torch.sort(ybounds[..., 0], dim=1, stable=True).indices[..., None]
    rows = torch.gather(rows, 1, order.expand(-1, -1, rows.shape[-1]))
    attrs = torch.gather(attrs, 1, order.expand(-1, -1, attrs.shape[-1]))
    ybounds = torch.gather(ybounds, 1, order.expand(-1, -1, 2))
    return rows, attrs, grid, ybounds, prep["pvm"]


# ---------------------------------------------------------------------------
# The "jnp" path: peel (B9), first surviving layer, shade
# (raster_jnp.py:261-414, 594-614), with the env batch written out.
# ---------------------------------------------------------------------------


def _sample(img, u, v):
    """NEAREST + REPEAT texel of a paletted image at texel coords (u, v)."""
    h, w = img.shape
    x = torch.remainder(to_i32(torch.floor(u)), w)
    y = torch.remainder(to_i32(torch.floor(v)), h)
    return img[y.long(), x.long()]


def layer_uv(prep, tid, grid):
    """Perspective-correct atlas uv (B, P, 2), w (B, P) and pass (B, P)
    of triangles tid (B, P) at the pixels grid (3, P)."""
    bidx = torch.arange(tid.shape[0], device=tid.device)[:, None]
    et = prep["e"][bidx, tid]  # (B, P, 3, 3)
    g0, g1, g2 = grid[0], grid[1], grid[2]
    lam = et[..., 0] * g0[:, None] + et[..., 1] * g1[:, None] + et[..., 2] * g2[:, None]
    slam = lam[..., 0] + lam[..., 1] + lam[..., 2]
    safe = torch.where(slam == 0.0, 1.0, slam)
    alpha = lam / safe[..., None]  # (B, P, 3)
    tuv = prep["v_tile_uv_tri"][bidx, tid]  # (B, P, 3, 2)
    uv = (alpha[..., 0, None] * tuv[..., 0, :] + alpha[..., 1, None] * tuv[..., 1, :]
          + alpha[..., 2, None] * tuv[..., 2, :])
    ts = prep["v_tile_size_tri"][tid]  # (B, P, 2)
    safe_ts = torch.where(ts == 0.0, 1.0, ts)
    p_pass = prep["tri_pass"][tid]
    base = torch.where((p_pass == PASS_WALL)[..., None],
                       prep["v_atlas_b_tri"][bidx, tid], prep["v_atlas_a_tri"][bidx, tid])
    uv = torch.remainder(uv, safe_ts) + base
    w = prep["det"][bidx, tid] / safe
    return uv, w, p_pass


def alpha_survives(scene, prep, tid, grid, has):
    """Does each layer texel (B, P) survive the GL discard test?"""
    uv, _, p_pass = layer_uv(prep, tid, grid)
    al_wall = _sample(scene.walls_atlas_alpha, uv[..., 0], uv[..., 1])
    al_dec = _sample(scene.decor_atlas_alpha, uv[..., 0], uv[..., 1])
    keep = torch.where(p_pass == PASS_DECOR, al_dec, al_wall).bool()
    return has & torch.where(prep["transparent"][tid], keep, True)


def winner_from_layers(scene, prep, z_layers, id_layers, grid):
    """First of the K (z, id) layers (B, K, P) whose texel survives ->
    triangle ids (B, P), -1 where uncovered."""
    T = prep["e"].shape[1]
    B, K, P = z_layers.shape
    best = torch.full((B, P), -1, dtype=torch.int64, device=z_layers.device)
    resolved = torch.zeros((B, P), dtype=torch.bool, device=z_layers.device)
    for k in range(K):
        ids = id_layers[:, k].long()
        has = torch.isfinite(z_layers[:, k]) & (ids < T)
        tid = torch.where(has, ids, 0).clamp_max(T - 1)
        win = alpha_survives(scene, prep, tid, grid, has) & ~resolved
        best = torch.where(win, tid, best)
        resolved = resolved | win | ~has
    return best


def shade(scene, width, height, prep, best_id, grid):
    """Fragment shading of the winning triangles (B, P) -> (indices u8,
    covered bool), each (B, P)."""
    covered = best_id >= 0
    tid = best_id.clamp_min(0)
    uv, w, p_pass = layer_uv(prep, tid, grid)
    u, v = uv[..., 0], uv[..., 1]
    texel = torch.where(
        p_pass == PASS_FLAT, _sample(scene.flats_atlas, u, v),
        torch.where(p_pass == PASS_WALL, _sample(scene.walls_atlas_index, u, v),
                    _sample(scene.decor_atlas_index, u, v))).long()
    lights_f = prep["lights_f"]
    li = prep["v_light_tri"][tid].long().clamp(0, lights_f.shape[1] - 1)
    v_light = torch.gather(lights_f, 1, li)
    dist_s = torch.clamp_max(1.0 - rdiv(DIST_SCALE_STATIC, w + DIST_SCALE_STATIC), 1.0)
    dist_d = torch.clamp_max(1.0 - rdiv(DIST_SCALE_SPRITE, w + DIST_SCALE_SPRITE), 1.0)
    light = torch.where(p_pass == PASS_DECOR,
                        torch.minimum(v_light, v_light * LIGHT_SCALE - dist_d),
                        v_light * LIGHT_SCALE - dist_s)
    n_rows = scene.palette_lut.shape[0]
    row = to_i32(torch.floor((1.0 - light) * float(n_rows))).clamp(0, n_rows - 1)
    cmaps = scene.colormaps.long()
    index_static = cmaps[row.long(), texel]
    sky_x, sky_y = sky_coords(scene, width, height, prep["pvm"], grid)
    index_sky = cmaps[0][scene.sky_index.long()[sky_y.long(), sky_x.long()]]
    index = torch.where(p_pass == PASS_SKY, index_sky, index_static)
    return torch.where(covered, index, 0).to(torch.uint8), covered


def render_frames_jnp(scene, cfg, state, width: int, height: int):
    """The "jnp" triangle path -> (indices (B, H, W) u8, covered (B, H, W)
    bool): B9's K layers of unsorted rows, the first layer whose texel
    survives, then the shade. The depth is B9's z = zr . p with zr = vz /
    det rounded first, where the JAX package's dense peel computes
    (vz . p) / det."""
    B = state.pos.shape[0]
    grid = pixel_grid(width, height, state.pos.device)
    prep = prepare(scene, cfg, width, height, state)
    rows = pack_triangle_rows(prep["e"], prep["det"], prep["vz"], prep["vs"])
    z, ids = depth_peel(rows, grid, max(int(cfg.depth_layers), 1), width=width)
    best = winner_from_layers(scene, prep, z, ids, grid)
    idx, cov = shade(scene, width, height, prep, best, grid)
    return idx.reshape(B, height, width), cov.reshape(B, height, width)


def render_frames(scene, cfg, state, width: int, height: int):
    """Triangle path for every env -> (indices (B, H, W) u8, covered
    (B, H, W) bool): the "jnp" path for the two reference configurations,
    else the fused peel + resolve (B3)."""
    if cfg.raster_backend in ("jnp", "portal_jnp"):
        return render_frames_jnp(scene, cfg, state, width, height)
    B = state.pos.shape[0]
    rows, attrs, grid, ybounds, pvm = peel_inputs(scene, cfg, width, height, state)
    channels = peel_resolve(rows, attrs, grid, ybounds, max(int(cfg.depth_layers), 1),
                            tile_p=cfg.raster_tile_p, chunk_t=cfg.raster_chunk_t,
                            width=width)
    idx, cov = shade_from_channels(scene, width, height, channels, pvm, grid)
    return idx.reshape(B, height, width), cov.reshape(B, height, width)


def frames_to_rgb(palette, indices, covered=None):
    """Palette-index frames -> RGB u8; uncovered pixels get the GL clear
    colour (0.06, 0.07, 0.09)."""
    rgb = palette[indices.long()]
    if covered is not None:
        clear = torch.tensor([int(0.06 * 255), int(0.07 * 255), int(0.09 * 255)],
                             dtype=torch.uint8, device=rgb.device)
        rgb = torch.where(covered[..., None], rgb, clear)
    return rgb
