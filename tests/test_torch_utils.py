"""The port's utilities against the JAX package's: the YAML reader of
``configs/*.yml`` (against PyYAML's ``safe_load``) and ``load_config``
(against the JAX package's), ``utils/flops.py`` and the numerical guards
(as ``tests/test_utils.py``), the logger, the profiler trace, and
``write_video``'s GIF (read back by Pillow)."""

import dataclasses
import glob
import io
import json
import logging
import os

import numpy as np
import pytest
import torch
import yaml

from nerf_kinematics_tpu.train import config as jcfg
from nerf_kinematics_tpu.utils import flops as jflops
from nerf_kinematics_tpu_torch.io.image import encode_gif, write_video
from nerf_kinematics_tpu_torch.train import config as tcfg
from nerf_kinematics_tpu_torch.train.config import parse_yaml
from nerf_kinematics_tpu_torch.utils import flops as tflops
from nerf_kinematics_tpu_torch.utils.guards import assert_finite_tree, checked_step
from nerf_kinematics_tpu_torch.utils.profiling import device_trace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(ROOT, "configs", "*.yml")))


# ---------------------------------------------------------------- YAML

@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_yaml_reader_equals_safe_load_on_every_config(path):
    with open(path) as f:
        text = f.read()
    assert parse_yaml(text, path) == yaml.safe_load(text)


# the plain scalars the configs use, as YAML 1.1 resolves them; comments,
# nesting
SCALARS = """\
# a comment line
top: 1   # a trailing comment
zero: 0
exp: 1.5e+3
dot_first: .5
dot_last: 1.
neg_float: -0.25
yes_word: yes
off_word: Off
true_word: TRUE
tilde: ~
null_word: Null
empty:
text: plain text with spaces
hash_inside: a#b
colon_inside: a:b
path: /data/scene
nested:
  deeper:
    leaf: -12
    other: +12
  sibling: 3.25
2: the key is an int
after_nested: last
"""


def test_yaml_reader_resolves_scalars_as_safe_load():
    got, want = parse_yaml(SCALARS), yaml.safe_load(SCALARS)
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k] == v and type(got[k]) is type(v), (k, got[k], v)
    # what safe_dump writes of a config dict reads back the same
    raw = yaml.safe_load(open(CONFIGS[0]).read())
    raw["experiment"]["logdir"] = "/tmp/some dir"
    assert parse_yaml(yaml.safe_dump(raw)) == raw
    assert parse_yaml("") is None and parse_yaml("# only a comment\n") is None


@pytest.mark.parametrize("text,line", [
    ("a: [1, 2]", 1), ("a: {b: 1}", 1), ("- 1", 1), ("a:\n  - 1", 2),
    ("a: &x 1", 1), ("a: *x", 1), ("a: !!str 1", 1), ("a: |\n  x", 1),
    ("a: >\n  x", 1), ("a: 1\n   b: 2", 2), ("a:\n  b: 1\n c: 2", 3),
    ("a: b: c", 1), ("---\na: 1", 1), ("a: 2001-12-14", 1), ("\ta: 1", 1),
    ("a: 'x", 1), ("just a scalar", 1), ("x: 1\na: \"b\" c", 2),
    ("a: 1\nb: \"\\q\"", 2),
    # quoted scalars and keys, and number forms the configs do not use
    ("a: 'x'", 1), ("a: \"x\"", 1), ("x: 1\n'k': 1", 2), ("a: 0x1F", 1),
    ("a: 017", 1), ("a: -0b101", 1), ("a: 1_000", 1), ("a: 190:20:30", 1),
    ("a: 1:30.5", 1), ("a: 1e-3", 1), ("a: .inf", 1), ("a: -.Inf", 1),
    ("a: .NaN", 1),
], ids=lambda v: repr(v) if isinstance(v, str) else str(v))
def test_yaml_reader_refuses_what_it_does_not_read(text, line):
    with pytest.raises(ValueError, match=rf"cfg\.yml:{line}:"):
        parse_yaml(text, "cfg.yml")


def _jax_config_json(cfg) -> str:
    """The port's config_to_json recipe applied to a JAX package Config."""
    d = jcfg.config_to_dict(cfg)
    d["nerf"]["coarse_loss_weight"] = cfg.nerf.coarse_loss_weight
    d["nerf"]["ema_decay"] = cfg.nerf.ema_decay
    d["engine"] = cfg.engine
    if cfg.ngp is not None:
        d["ngp"] = dataclasses.asdict(cfg.ngp)
    return json.dumps(d, sort_keys=True)


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_load_config_matches_the_jax_package(path):
    """Through the port's reader, no PyYAML: the same configuration."""
    t = tcfg.load_config(path)
    assert tcfg.config_to_json(t) == _jax_config_json(jcfg.load_config(path))
    assert tcfg.config_from_json(tcfg.config_to_json(t)) == t


def test_load_config_needs_no_pyyaml(monkeypatch, tmp_path):
    import builtins

    real = builtins.__import__

    def no_yaml(name, *a, **k):
        if name == "yaml" or name.startswith("yaml."):
            raise ImportError("no PyYAML on this machine")
        return real(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_yaml)
    cfg = tcfg.load_config(os.path.join(ROOT, "configs", "machina_ngp.yml"))
    assert cfg.engine == "ngp" and cfg.ngp.cp.n_components == 64
    bad = tmp_path / "bad.yml"
    bad.write_text("engine: ngp\nngp: [1]\n")
    with pytest.raises(ValueError, match="bad.yml:2"):
        tcfg.load_config(str(bad))


# ---------------------------------------------------------------- flops

@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_flops_equal_the_jax_package(path):
    j, t = jcfg.load_config(path), tcfg.load_config(path)
    for n_rays in (1, 8192):
        for useful in (False, True):
            assert tflops.train_step_flops(t, n_rays, useful) == \
                jflops.train_step_flops(j, n_rays, useful)
        assert tflops.train_step_useful_flops(t, n_rays) == \
            jflops.train_step_useful_flops(j, n_rays)
    assert tflops.classic_flops_per_point(t.model_coarse, t.nerf.use_viewdirs) == \
        jflops.classic_flops_per_point(j.model_coarse, j.nerf.use_viewdirs)
    if t.ngp is not None:
        for trained in (False, True):
            for useful in (False, True):
                assert tflops.ngp_flops_per_point(t.ngp, trained, useful) == \
                    jflops.ngp_flops_per_point(j.ngp, trained, useful)
            assert tflops.ngp_useful_flops_per_point(t.ngp, trained) == \
                jflops.ngp_useful_flops_per_point(j.ngp, trained)
            assert tflops.cp_encoder_flops_per_point(t.ngp.cp, trained) == \
                jflops.cp_encoder_flops_per_point(j.ngp.cp, trained)
            assert tflops.cp_encoder_useful_flops_per_point(t.ngp.cp, trained) == \
                jflops.cp_encoder_useful_flops_per_point(j.ngp.cp, trained)
        assert tflops.hash_encoder_flops_per_point(t.ngp.grid) == \
            jflops.hash_encoder_flops_per_point(j.ngp.grid)
    assert tflops.PEAK_FLOPS["bf16"] == 989e12


# ------------------------------------------------------- guards, logging

def test_assert_finite_tree():
    from nerf_kinematics_tpu_torch.train.loop import AdamState, TrainState

    assert_finite_tree({"a": torch.ones(3), "n": np.ones(2), "i": torch.arange(3)})
    with pytest.raises(FloatingPointError, match="a"):
        assert_finite_tree({"a": torch.tensor([1.0, float("nan")])})
    with pytest.raises(FloatingPointError, match=r"\['w'\]\[1\]"):
        assert_finite_tree({"w": [np.zeros(2), np.array([np.inf])]})
    z = torch.zeros(3)
    state = TrainState(torch.zeros((), dtype=torch.int64), torch.ones(3),
                       AdamState(z, z.clone(), torch.zeros((), dtype=torch.int64)),
                       torch.Generator())
    assert_finite_tree(state, "state")
    state.opt_state.nu[1] = float("inf")
    with pytest.raises(FloatingPointError, match=r"opt_state\.nu"):
        assert_finite_tree(state, "state")


def test_checked_step_catches_nan():
    def bad_step(x):
        return torch.log(x)  # NaN for a negative input

    wrapped = checked_step(bad_step)
    assert torch.isfinite(wrapped(torch.tensor(2.0)))
    with pytest.raises(FloatingPointError):
        wrapped(torch.tensor(-1.0))

    def bad_backward(w):  # finite forward, NaN gradient: inf * 0
        loss = torch.sqrt(w * 0.0).sum()
        loss.backward()
        return loss.detach()

    with pytest.raises(RuntimeError, match="nan"):
        checked_step(bad_backward)(torch.ones(2, requires_grad=True))


def test_logger_levels(caplog):
    from nerf_kinematics_tpu_torch.utils import get_logger, progress, success
    from nerf_kinematics_tpu_torch.utils.logging import PROGRESS, SUCCESS

    log = get_logger("train")
    assert log.name == "nerf_kinematics_tpu_torch.train"
    with caplog.at_level(PROGRESS, logger="nerf_kinematics_tpu_torch"):
        success(log, "done %d", 3)
        progress(log, "step %d", 4)
    levels = [(r.levelname, r.getMessage()) for r in caplog.records]
    assert ("SUCCESS", "done 3") in levels and ("PROGRESS", "step 4") in levels
    assert logging.getLevelName(SUCCESS) == "SUCCESS"


def test_device_trace_writes_a_chrome_trace(tmp_path):
    with device_trace(str(tmp_path / "trace")) as prof:
        (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    with open(tmp_path / "trace" / "trace.json") as f:
        assert "traceEvents" in json.load(f)
    assert any("mm" in e.key for e in prof.key_averages())


# ---------------------------------------------------------------- video

def test_write_video_gif_decodes_in_pillow(tmp_path):
    from PIL import Image, ImageSequence

    rng = np.random.default_rng(0)
    frames = [rng.uniform(0, 1, (21, 34, 3)) for _ in range(5)]
    out = write_video(str(tmp_path / "v.mp4"), frames, fps=5)
    assert out.endswith(".gif") or out.endswith(".mp4")
    gif = write_video(str(tmp_path / "v.gif"), frames, fps=5)
    with Image.open(gif) as im:
        got = [np.asarray(f.convert("RGB")).astype(int) for f in ImageSequence.Iterator(im)]
        assert im.info["loop"] == 0 and im.info["duration"] == 200
    assert len(got) == 5
    for g, f in zip(got, frames):
        want = np.clip(f * 255, 0, 255).astype(np.uint8).astype(int)
        assert g.shape == (21, 34, 3)
        assert np.abs(g - want).max() <= 26  # half the palette's step of 51
    # 256 x 256 random pixels: many clear codes, 9-bit codes throughout
    big = rng.integers(0, 256, (256, 256, 3), dtype=np.uint8)
    with Image.open(io.BytesIO(encode_gif([big, big[::-1]]))) as im:
        frames2 = [np.asarray(f.convert("RGB")).astype(int) for f in ImageSequence.Iterator(im)]
    assert len(frames2) == 2 and np.abs(frames2[1] - big[::-1]).max() <= 26
    with pytest.raises(ValueError):
        encode_gif([])


@pytest.mark.parametrize("colors", [2, 4, 16, 200], ids=lambda c: f"{c}colors")
def test_png_reader_reads_packed_palettes(colors):
    """Pillow writes a palette of 2, 4 or 16 colors with 1, 2 or 4 bits a
    pixel (200: 8 bits); rows of odd widths end mid-byte."""
    from PIL import Image

    from nerf_kinematics_tpu_torch.io.image import decode_png

    rng = np.random.default_rng(colors)
    im = Image.fromarray((rng.integers(0, colors, (9, 13))).astype(np.uint8), "P")
    im.putpalette(list(rng.integers(0, 256, 3 * colors).astype(int)))
    buf = io.BytesIO()
    im.save(buf, format="PNG")
    data = buf.getvalue()
    assert data[24] == {2: 1, 4: 2, 16: 4, 200: 8}[colors]  # IHDR's bit depth
    want = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    np.testing.assert_array_equal(decode_png(data), want)
