"""The port's twin of `__graft_entry__.entry()`: one step + render of the
flagship model and example arguments.

    from tpu_doom_torch.entry import entry
    fn, (state, actions) = entry()            # on the card
    state, frames = fn(state, actions)

`fn` is a tick that `graphs.CapturedTick(fn, state, actions)` captures
as one CUDA graph: its state the SimState, its other output the (B, H, W)
u8 frames.
"""

from __future__ import annotations


def entry_sim(device="cuda"):
    """The DoomSim `entry()` drives: the synthetic IWAD at 64x40, 2 envs,
    through the portal renderer, on `device`."""
    from .models import DoomSim
    from .utils.config import GameConfig, PlayerConfig

    return DoomSim(GameConfig(wad_file=":test:", width=64, height=40, batch_size=2,
                              raster_backend="portal", portal_crossings=12,
                              player=PlayerConfig(clip_substeps=2)), device)


def entry(device="cuda"):
    """(fn, (state, actions)): `fn(state, actions) -> (state, frames)`
    steps and renders `entry_sim(device)` (the card unless the caller
    asks for the CPU, where the kernels' plain versions run)."""
    from .render import render_dispatch
    from .sim.step import step as sim_step

    sim = entry_sim(device)
    scene, cfg, pscene = sim.scene, sim.config, sim.portal_scene()

    def fn(state, actions):
        state = sim_step(scene, cfg, state, actions)
        frames, _ = render_dispatch(scene, pscene, cfg, state, cfg.width, cfg.height)
        return state, frames

    return fn, (sim.reset(2), sim.null_actions(2))
