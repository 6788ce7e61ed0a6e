"""The port's entry points and host helpers against the JAX package's, on
the CPU (`--device cpu` / `device="cpu"`: the kernels' plain versions):

(a) `python -m tpu_doom_torch.cli` list-levels, check and --version, and
    the default device raising without a card.
(b) `dump-frames --backend portal_jnp -r 64x40 --ticks 21 --every 10`
    through both CLIs: the port's frames within the largest entry of
    tests/test_torch_render.py's PORTAL_CEILING per frame (the ceiling
    tests/test_torch_rollout.py holds portal_jnp trajectories to), the
    manifest's pose fields within tests/test_torch_sim.py's
    TRAJECTORY_DRIFT_CEILING (1e-3), its other fields equal.
(c) `demo` writes PNGs.
(d) A checkpoint written by either package's `save_state` loads bitwise
    in the other.
(e) The port's `entry()` fn against the JAX package's jitted `entry()`
    fn from identical inputs: float state fields within 4 ulp (B1's
    ceiling, ROADMAP C), the others equal, frames <= 16 px (the verify
    legs' ceiling).
(f) `scripted_actions`: bitwise the JAX pilot's, and built with no data
    from the host (tests/test_torch_rollout.py's TorchDispatchMode).
(h) The copied helpers (`utils/ttf`, `text`, `input`, `viewer`) give
    bitwise the JAX package's outputs on the cases of tests/test_ttf.py
    and tests/test_input.py.
"""

import importlib
import importlib.util
import json
import os
import subprocess
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_doom_torch import cli
from tpu_doom_torch.sim.state import Actions, SimState, state_from_numpy, state_to_numpy

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAJECTORY_DRIFT_CEILING = 1e-3  # tests/test_torch_sim.py
ENTRY_ULPS = 4  # B1's ceiling, ROADMAP C
FRAME_CEILING = 16  # the verify legs' ceiling (bench.py:88-90)
DISCRETE = ("fly", "noclip", "eff_active", "eff_has_second", "trig_alive",
            "exit_triggered", "tick")
TO_NP = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731


def _load_test_module(name):
    spec = importlib.util.spec_from_file_location(
        f"_{name}", os.path.join(os.path.dirname(__file__), f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# -- (a) ---------------------------------------------------------------------


def test_cli_module_lists_levels():
    """`python -m tpu_doom_torch.cli` in a fresh interpreter (the only
    subprocess of this file)."""
    r = subprocess.run([sys.executable, "-m", "tpu_doom_torch.cli", "--device", "cpu",
                        "--iwad", ":test:", "list-levels"],
                       capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-500:]
    assert r.stdout.split() == ["0", "E1M1", "1", "E1M2"]


def test_cli_check():
    assert cli.main(["--device", "cpu", "--iwad", ":test:", "check"]) == 0


def test_cli_version(capsys):
    with pytest.raises(SystemExit) as exc:
        cli.main(["--version"])
    assert exc.value.code == 0
    assert capsys.readouterr().out.strip() == "tpu-doom-torch 0.1.0"


def test_cli_default_device_raises_without_card():
    """The card is the default; without one the CLI raises rather than
    running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        cli.main(["--iwad", ":test:", "check"])


# -- (b), (c) -------------------------------------------------------------------


def test_dump_frames_matches_jax_cli(tmp_path):
    """(b) The same dump through both CLIs: frames within the largest
    PORTAL_CEILING entry, poses within TRAJECTORY_DRIFT_CEILING."""
    from tpu_doom import cli as jax_cli

    args = ["--iwad", ":test:", "-r", "64x40", "--backend", "portal_jnp", "dump-frames",
            "--ticks", "21", "--every", "10", "--out"]
    assert jax_cli.main(args + [str(tmp_path / "jax")]) == 0
    assert cli.main(["--device", "cpu"] + args + [str(tmp_path / "port")]) == 0
    ceiling = max(_load_test_module("test_torch_render").PORTAL_CEILING.values())
    jm = json.loads((tmp_path / "jax" / "manifest.json").read_text())
    pm = json.loads((tmp_path / "port" / "manifest.json").read_text())
    assert {k: v for k, v in pm.items() if k not in ("frames", "out")} == {
        k: v for k, v in jm.items() if k not in ("frames", "out")}
    assert len(pm["frames"]) == len(jm["frames"]) == 3
    for jf, pf in zip(jm["frames"], pm["frames"]):
        assert (pf["tick"], pf["file"]) == (jf["tick"], jf["file"])
        for k in ("pos", "yaw", "pitch", "time"):
            np.testing.assert_allclose(pf[k], jf[k], rtol=0, atol=TRAJECTORY_DRIFT_CEILING,
                                       err_msg=k)
        a = np.load(tmp_path / "jax" / jf["file"])
        b = np.load(tmp_path / "port" / pf["file"])
        assert b.dtype == a.dtype == np.uint8 and b.shape == a.shape == (40, 64)
        assert int((a != b).sum()) <= ceiling, jf["file"]


def test_demo_writes_pngs(tmp_path):
    assert cli.main(["--device", "cpu", "--iwad", ":test:", "-r", "64x40", "demo",
                     "--ticks", "3", "--every", "2", "--out", str(tmp_path)]) == 0
    pngs = sorted(tmp_path.glob("*.png"))
    assert [p.name for p in pngs] == ["frame_00000.png", "frame_00002.png"]
    assert all(p.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n" for p in pngs)


# -- (d) ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def stepped_state():
    """A JAX SimState after 3 ticks of walking with a push (numpy leaves)."""
    from tpu_doom.models import DoomSim as JaxSim
    from tpu_doom.utils.config import GameConfig

    sim = JaxSim(GameConfig(wad_file=":test:", width=64, height=40,
                            raster_backend="portal_jnp"))
    s = sim.reset(3)
    a = sim.null_actions(3)._replace(
        movement=jnp.asarray(np.tile([[0.3, 1.0]], (3, 1)).astype(np.float32)),
        push=jnp.ones((3,), bool))
    for _ in range(3):
        s = sim.step(s, a)
    return TO_NP(s)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_loads_bitwise_across_packages(tmp_path, stepped_state, writer):
    """(d) The JAX package's .npz layout: either package's file loads
    bitwise, with its metadata, in the other."""
    from tpu_doom.utils import checkpoint as jax_ck
    from tpu_doom_torch.utils import checkpoint as port_ck

    path = str(tmp_path / "ck.npz")
    if writer == "jax":
        jax_ck.save_state(path, stepped_state, level=1, tag="e1m2")
        got, meta = port_ck.load_state(path, device="cpu")
        got = state_to_numpy(got)
    else:
        port_ck.save_state(path, state_from_numpy(stepped_state, "cpu"), level=1, tag="e1m2")
        got, meta = jax_ck.load_state(path)
        got = TO_NP(got)._asdict()
    for k in SimState._fields:
        want = np.asarray(getattr(stepped_state, k))
        assert got[k].dtype == want.dtype and got[k].shape == want.shape, k
        assert got[k].tobytes() == want.tobytes(), k
    assert int(meta["level"]) == 1 and str(meta["tag"]) == "e1m2"


def test_checkpoint_load_defaults_to_the_card(tmp_path, stepped_state):
    from tpu_doom_torch.utils import checkpoint as port_ck

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    path = str(tmp_path / "ck.npz")
    port_ck.save_state(path, state_from_numpy(stepped_state, "cpu"))
    with pytest.raises(RuntimeError, match="no CUDA card"):
        port_ck.load_state(path)


# -- (e) ---------------------------------------------------------------------------


def _ulps(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


def test_entry_fn_matches_jax_entry():
    """(e) Two ticks of each package's entry fn, each from identical
    inputs: the example arguments, then JAX's first state with seeded
    walking, turning and pushing actions."""
    sys.path.insert(0, ROOT)
    import __graft_entry__ as g

    from tpu_doom_torch.entry import entry

    jfn, (js, ja) = g.entry()
    jfn = jax.jit(jfn)
    pfn, (ps, pa) = entry(device="cpu")
    np.testing.assert_equal(state_to_numpy(ps), TO_NP(js)._asdict())
    rng = np.random.default_rng(5)
    walk = ja._replace(
        movement=jnp.asarray(rng.uniform(-1, 1, (2, 2)).astype(np.float32)),
        look=jnp.asarray(rng.uniform(-0.05, 0.05, (2, 2)).astype(np.float32)),
        push=jnp.asarray([True, False]))
    for acts in (ja, walk):
        js2, jframes = jfn(js, acts)
        with torch.no_grad():
            ps2, pframes = pfn(state_from_numpy(TO_NP(js), "cpu"),
                               Actions(*(torch.as_tensor(np.array(x)) for x in acts)))
        want, got = TO_NP(js2)._asdict(), state_to_numpy(ps2)
        for k in SimState._fields:
            if k in DISCRETE:
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            else:
                assert _ulps(got[k], want[k]).max(initial=0) <= ENTRY_ULPS, k
        assert pframes.shape == (2, 40, 64) and pframes.dtype == torch.uint8
        for e in range(2):
            assert int((pframes[e].numpy() != np.asarray(jframes[e])).sum()) <= FRAME_CEILING
        js = js2


# -- (f) ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def pilot_sims():
    from tpu_doom.models import DoomSim as JaxSim
    from tpu_doom.utils.config import GameConfig

    from tpu_doom_torch.models import DoomSim
    from tpu_doom_torch.utils.config import GameConfig as TorchConfig

    kw = dict(wad_file=":test:", width=64, height=40)
    return JaxSim(GameConfig(**kw)), DoomSim(TorchConfig(**kw), "cpu")


@pytest.mark.parametrize("t", [0, 35, 89, 90, 200, 271])
def test_scripted_actions_match_jax_pilot(pilot_sims, t):
    from tpu_doom import cli as jax_cli

    jsim, psim = pilot_sims
    want = TO_NP(jax_cli.scripted_actions(jsim, jsim.reset(3), t))
    got = cli.scripted_actions(psim, psim.reset(3), t)
    for k in Actions._fields:
        w, g_ = np.asarray(getattr(want, k)), getattr(got, k).numpy()
        assert g_.dtype == w.dtype and g_.tobytes() == w.tobytes(), k


def test_scripted_actions_take_nothing_from_the_host(pilot_sims):
    sim = pilot_sims[1]
    state = sim.reset(3)
    mode = _load_test_module("test_torch_rollout")._HostTraffic([])
    mode.add(list(state))
    with mode:
        for t in (0, 90, 105):
            cli.scripted_actions(sim, state, t)
    assert mode.found == []


# -- (h) ---------------------------------------------------------------------------

FONT_PATH = os.path.join(ROOT, "assets", "ttf", "OpenSans-Regular.ttf")


def _helpers(pkg):
    return SimpleNamespace(**{m: importlib.import_module(f"{pkg}.utils.{m}")
                              for m in ("ttf", "text", "input", "viewer")})


def _rasterize(ch, size):
    def case(m, to_np):
        cov, metrics = m.ttf.TtfFont.open(FONT_PATH).rasterize(ch, size)
        return [cov, np.asarray(metrics, np.float64)]
    return case


def _outline(ch):
    def case(m, to_np):
        font = m.ttf.TtfFont.open(FONT_PATH)
        return font.glyph_outline(font.glyph_index(ch))
    return case


def _draw_text(m, to_np):
    img = np.zeros((64, 320, 3), np.uint8)
    m.ttf.draw_ttf_text(img, (4, 40), "Hello, Doom! 42", 24.0, color=(255, 200, 100))
    bitmap = m.text.draw_text(np.zeros((16, 120, 3), np.uint8), "E1M1 60 FPS", 2, 2)
    return [img, bitmap]


def _hud(ttf, show_help):
    def case(m, to_np):
        rgb = np.zeros((96, 320, 3), np.uint8)
        m.text.draw_hud(rgb, level_name="E1M1", fps=60.0, show_help=show_help, ttf=ttf)
        return [rgb]
    return case


def _inputs(events):
    """Feed `events` to an InputState; each "poll" records every binding's
    gesture and the Actions of 2 envs."""
    def case(m, to_np):
        inp, b, out = m.input.InputState(), m.input.Bindings(), []
        for ev in events:
            if ev == "poll":
                out += [np.asarray(inp.poll_gesture(getattr(b, g)))
                        for g in ("jump", "push", "shoot", "fly", "clip", "quit",
                                  "next_level", "previous_level", "toggle_help")]
                out += to_np(m.input.poll_actions(inp, b, 2, **m.device))
            elif ev == "advance":
                inp.advance()
            else:
                getattr(inp, ev[0])(*ev[1:])
        return out
    return case


def _sgr_mouse(m, to_np):
    return [m.viewer.parse_sgr_mouse(s) for s in
            ("35;10;5M", "0;3;4M", "0;3;4m", "2;7;1M", "", "1;2", "x;y;zM", "64;1;1M")]


def _ansi(m, to_np):
    rgb = np.random.default_rng(0).integers(0, 4, (7, 9, 3)).astype(np.uint8) * 60
    return [m.viewer.frame_to_ansi(rgb)]


HELPER_CASES = {
    "ttf_rasterize_A24": _rasterize("A", 24.0),
    "ttf_rasterize_O12": _rasterize("O", 12.0),
    "ttf_rasterize_O32": _rasterize("O", 32.0),
    "ttf_rasterize_O48": _rasterize("O", 48.0),
    "ttf_outline_I": _outline("I"),
    "ttf_outline_A_acute": _outline("Á"),
    "draw_text": _draw_text,
    "hud_ttf": _hud(True, True),
    "hud_bitmap": _hud(False, True),
    "hud_status_only": _hud(None, False),
    "input_key_trigger": _inputs([("key_down", "e"), "poll", "advance", "poll",
                                  ("key_up", "e"), ("key_down", "e"), "poll"]),
    "input_key_hold": _inputs([("key_down", "w"), "poll", "advance", "poll", "advance",
                               "poll"]),
    "input_allof_chord": _inputs([("key_down", "n"), "poll", ("key_down", "lcontrol"),
                                  "poll"]),
    "input_quit": _inputs([("quit_requested",), "poll", "advance", "poll"]),
    "input_mouse_look": _inputs([("mouse_motion", 100.0, -40.0), "poll", "advance", "poll"]),
    "input_click": _inputs([("button_down", 0), "poll", "advance", "poll",
                            ("button_up", 0), "poll"]),
    "input_keys_at_once": _inputs([("key_down", "left"), ("key_down", "d"), ("key_down", "up"),
                                   "poll", ("key_down", "space"), ("key_down", "f"),
                                   ("key_down", "c"), ("mouse_motion", -3.0, 7.5), "poll"]),
    "sgr_mouse": _sgr_mouse,
    "frame_to_ansi": _ansi,
}


def _flat(x):
    if isinstance(x, (list, tuple)) and not hasattr(x, "_fields"):
        return [y for v in x for y in _flat(v)]
    return [x]


@pytest.mark.parametrize("case", sorted(HELPER_CASES))
def test_copied_helpers_match_jax_package(case):
    """(h) Bitwise: arrays by dtype, shape and bytes, the rest by ==."""
    jax_m, port_m = _helpers("tpu_doom"), _helpers("tpu_doom_torch")
    jax_m.device, port_m.device = {}, {"device": "cpu"}
    want = _flat(HELPER_CASES[case](jax_m, lambda a: [np.asarray(x) for x in a]))
    got = _flat(HELPER_CASES[case](port_m, lambda a: [x.numpy() for x in a]))
    assert len(got) == len(want) > 0
    for g_, w in zip(got, want):
        if isinstance(w, np.ndarray):
            assert isinstance(g_, np.ndarray) and g_.dtype == w.dtype and g_.shape == w.shape
            assert g_.tobytes() == w.tobytes()
        else:
            assert g_ == w
