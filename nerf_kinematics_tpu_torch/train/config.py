"""One dataclass-based config system accepting the reference YAML schema
verbatim: sections ``dataset / experiment / models / nerf / optimizer /
scheduler`` plus ``engine`` and ``ngp``.

YAML files are read by :func:`parse_yaml`, the port's own reader of the
YAML that ``configs/*.yml`` use (block mappings, scalars and comments), with
PyYAML's ``safe_load`` resolution of the scalars: machines without PyYAML
read the shipped configs through the same code as every other machine.
"""

from __future__ import annotations

import dataclasses
import json
import re
from dataclasses import dataclass, field
from typing import Optional

from ..models.ngp import NGPConfig
from ..ops.positional_encoding import encoding_dim
from ..rendering.renderer import RenderSettings


def _filtered(cls, d: dict):
    keys = set(cls.__dataclass_fields__)
    unknown = set(d) - keys
    if unknown:
        raise ValueError(f"unknown {cls.__name__} keys: {sorted(unknown)}")
    return cls(**d)


@dataclass(frozen=True)
class FlexibleNeRFConfig:
    """Shape of the classic engine's MLP (``models.coarse`` / ``models.fine``
    of the YAML), the model of ``models/flexible_nerf.py``. The xyz trunk has
    ``num_layers // 2`` layers; trunk layer i > 0 concatenates gamma(xyz) to
    its input when ``i % skip_connect_every == 0``. ``compute_dtype`` is the
    operand type of the products ("float32" | "bfloat16"; parameters stay
    f32). ``fused``: "auto" and "on" send the point pipeline through
    ``ops/classic_fused_cuda.py`` (the kernel for CUDA tensors, its plain
    version for CPU tensors) where the config is supported, "off" keeps the
    module."""

    num_layers: int = 8
    hidden_size: int = 128
    skip_connect_every: int = 3
    num_encoding_fn_xyz: int = 10
    num_encoding_fn_dir: int = 4
    include_input_xyz: bool = True
    include_input_dir: bool = True
    log_sampling_xyz: bool = True
    log_sampling_dir: bool = True
    use_viewdirs: bool = True
    compute_dtype: str = "float32"
    fused: str = "auto"

    @property
    def dim_xyz(self) -> int:
        return encoding_dim(3, self.num_encoding_fn_xyz, self.include_input_xyz)

    @property
    def dim_dir(self) -> int:
        return encoding_dim(3, self.num_encoding_fn_dir, self.include_input_dir)

    @property
    def trunk_depth(self) -> int:
        return max(self.num_layers // 2, 1)

    @classmethod
    def from_model_cfg(cls, d: dict) -> "FlexibleNeRFConfig":
        keys = set(cls.__dataclass_fields__)
        return cls(**{k: v for k, v in d.items() if k in keys})


@dataclass(frozen=True)
class DatasetConfig:
    basedir: str = ""
    cachedir: Optional[str] = None
    type: str = "blender"  # blender | llff | robot | ngp
    near: float = 2.0
    far: float = 6.0
    half_res: bool = False
    no_ndc: bool = True
    testskip: int = 1
    downsample_factor: int = 1
    llffhold: int = 8


@dataclass(frozen=True)
class ExperimentConfig:
    id: str = "experiment"
    logdir: str = "logs"
    print_every: int = 100
    randomseed: int = 42
    save_every: int = 5000
    train_iters: int = 200000
    validate_every: int = 100


@dataclass(frozen=True)
class NeRFConfig:
    train: RenderSettings = field(default_factory=RenderSettings)
    validation: RenderSettings = field(default_factory=lambda: RenderSettings(perturb=False))
    use_viewdirs: bool = True
    encode_position_fn: str = "positional_encoding"
    encode_direction_fn: str = "positional_encoding"
    num_random_rays: int = 1024
    # Weight of the coarse-pass MSE in the total loss. -1 = engine default
    # (1.0 classic, 0.0 NGP: the passes share parameters, and the coarse
    # pass stays forward-only for sample placement).
    coarse_loss_weight: float = -1.0
    # Per-step exponential moving average of the parameters, used for
    # validation / eval / serving renders (0 = off).
    ema_decay: float = 0.0


@dataclass(frozen=True)
class OptimizerConfig:
    type: str = "Adam"
    lr: float = 5.0e-3


@dataclass(frozen=True)
class SchedulerConfig:
    # lr0 * factor^(step / (lr_decay * 1000))
    lr_decay: int = 250
    lr_decay_factor: float = 0.1


@dataclass(frozen=True)
class Config:
    dataset: DatasetConfig = field(default_factory=DatasetConfig)
    experiment: ExperimentConfig = field(default_factory=ExperimentConfig)
    model_coarse: FlexibleNeRFConfig = field(default_factory=FlexibleNeRFConfig)
    model_fine: Optional[FlexibleNeRFConfig] = field(default_factory=FlexibleNeRFConfig)
    nerf: NeRFConfig = field(default_factory=NeRFConfig)
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    scheduler: SchedulerConfig = field(default_factory=SchedulerConfig)
    # Engine selection: "classic" or "ngp" (YAML: top-level ``engine: ngp``
    # plus an ``ngp:`` section).
    engine: str = "classic"
    ngp: Optional[NGPConfig] = None

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


def config_from_dict(raw: dict) -> Config:
    """Build a Config from a parsed reference-schema YAML dict."""
    raw = dict(raw)

    dataset = _filtered(DatasetConfig, raw.get("dataset", {}))
    experiment = _filtered(ExperimentConfig, raw.get("experiment", {}))

    models = raw.get("models", {})
    coarse = FlexibleNeRFConfig.from_model_cfg(models.get("coarse", {}))
    fine = (
        FlexibleNeRFConfig.from_model_cfg(models["fine"]) if "fine" in models else None
    )

    nerf_raw = dict(raw.get("nerf", {}))
    train_raw = dict(nerf_raw.pop("train", {}))
    num_random_rays = train_raw.pop("num_random_rays", 1024)
    val_raw = dict(nerf_raw.pop("validation", {}))
    val_raw.pop("num_random_rays", None)
    nerf = NeRFConfig(
        train=RenderSettings.from_cfg(train_raw),
        validation=RenderSettings.from_cfg(val_raw),
        use_viewdirs=nerf_raw.get("use_viewdirs", True),
        encode_position_fn=nerf_raw.get("encode_position_fn", "positional_encoding"),
        encode_direction_fn=nerf_raw.get("encode_direction_fn", "positional_encoding"),
        num_random_rays=num_random_rays,
        coarse_loss_weight=float(nerf_raw.get("coarse_loss_weight", -1.0)),
        ema_decay=float(nerf_raw.get("ema_decay", 0.0)),
    )

    optimizer = _filtered(OptimizerConfig, raw.get("optimizer", {}))
    scheduler = _filtered(SchedulerConfig, raw.get("scheduler", {}))

    engine = raw.get("engine", "classic")
    ngp = NGPConfig.from_cfg(raw.get("ngp", {})) if (engine == "ngp" or "ngp" in raw) else None

    return Config(
        dataset=dataset,
        experiment=experiment,
        model_coarse=coarse,
        model_fine=fine,
        nerf=nerf,
        optimizer=optimizer,
        scheduler=scheduler,
        engine=engine,
        ngp=ngp,
    )


def load_config(path) -> Config:
    """Load a reference-schema YAML config file (:func:`parse_yaml`)."""
    with open(path, "r") as f:
        return config_from_dict(parse_yaml(f.read(), str(path)))


# -- the YAML subset of configs/*.yml ----------------------------------------
#
# Block mappings nested by indentation (spaces), one ``key: value`` or
# ``key:`` a line, plain scalars, comments and blank lines. Plain scalars
# resolve as PyYAML's safe_load resolves them where the configs use them:
# decimal ints and floats, YAML 1.1 booleans (yes / no / on / off too),
# null, strings. Anything else (quoted scalars, other number forms, sequences,
# flow style, anchors, tags, block scalars, several documents, multi-line
# scalars) raises a ValueError naming the line.

_YAML_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE"
                        r"|on|On|ON|off|Off|OFF)$")
_YAML_TRUE = {"yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON"}
_YAML_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_YAML_INT = re.compile(r"^[-+]?(?:0|[1-9][0-9]*)$")
_YAML_FLOAT = re.compile(r"^[-+]?(?:[0-9]+\.[0-9]*|\.[0-9]+)(?:[eE][-+][0-9]+)?$")
# what safe_load might read as a number or a date: a decimal int or float
# above, or refused
_YAML_NUMERIC = re.compile(r"^[-+]?(?:\.?[0-9]|\.(?:inf|Inf|INF|nan|NaN|NAN)$)")


def _yaml_scalar(text: str, where: str):
    if text[:1] in set("'\"[]{}&*!|>%@`,?") or text.startswith(("- ", "-\t")) or text == "-":
        raise ValueError(f"{where}: {text!r} is not in the YAML this reader takes "
                         "(block mappings of plain scalars only)")
    if ": " in text or text.endswith(":") or " #" in text or "\t#" in text:
        raise ValueError(f"{where}: {text!r} is not a scalar")
    if _YAML_NULL.match(text):
        return None
    if _YAML_BOOL.match(text):
        return text in _YAML_TRUE
    if _YAML_INT.match(text):
        return int(text)
    if _YAML_FLOAT.match(text):
        return float(text)
    if _YAML_NUMERIC.match(text):
        raise ValueError(f"{where}: {text!r}: only decimal ints and floats are in "
                         "the YAML this reader takes")
    return text


def _yaml_strip_comment(line: str) -> str:
    """The line without its comment: a ``#`` at the start or after
    whitespace."""
    m = re.search(r"(?:^|[ \t])#", line)
    return (line[: m.start()] if m else line).rstrip()


def _yaml_split_key(body: str, where: str):
    """``key: value`` / ``key:`` -> (key, value text)."""
    m = re.match(r"^(.*?):(?:[ \t]+|$)", body)
    if m is None or not m.group(1):
        raise ValueError(f"{where}: expected 'key: value', got {body!r}")
    return _yaml_scalar(m.group(1), where), body[m.end():].strip()


def parse_yaml(text: str, name: str = "<yaml>"):
    """The document of ``text`` as ``yaml.safe_load`` gives it, for the YAML
    that ``configs/*.yml`` use: nested block mappings of plain scalars, with
    comments. Raises ValueError naming the line of anything else. An empty
    document gives None."""
    lines = []
    for n, raw in enumerate(text.splitlines(), start=1):
        where = f"{name}:{n}"
        line = _yaml_strip_comment(raw)
        if not line.strip():
            continue
        indent = len(line) - len(line.lstrip(" "))
        body = line[indent:]
        if body[:1] == "\t":
            raise ValueError(f"{where}: a tab in the indentation")
        if n == 1 and body in ("---", "%YAML"):
            raise ValueError(f"{where}: document markers are not in the YAML "
                             "this reader takes")
        lines.append((indent, body, where))
    if not lines:
        return None
    root: dict = {}
    stack = [(lines[0][0], root)]  # (indentation of a mapping's keys, mapping)
    pending = None  # (indentation, mapping, key) of the last line, a "key:"
    for indent, body, where in lines:
        if pending is not None:
            p_indent, p_map, p_key = pending
            pending = None
            if indent > p_indent:
                child: dict = {}
                p_map[p_key] = child
                stack.append((indent, child))
        while len(stack) > 1 and stack[-1][0] > indent:
            stack.pop()
        level, mapping = stack[-1]
        if level != indent:
            raise ValueError(f"{where}: indentation {indent} matches no mapping "
                             f"(its keys are at {level})")
        key, rest = _yaml_split_key(body, where)
        if rest:
            mapping[key] = _yaml_scalar(rest, where)
        else:
            mapping[key] = None
            pending = (indent, mapping, key)
    return root


def config_to_dict(cfg: Config) -> dict:
    """Serialize back to the reference YAML schema. As in the reference,
    ``engine`` and ``ngp`` are not part of it; :func:`config_to_json` adds
    them."""
    rs = lambda s: dataclasses.asdict(s)
    out = {
        "dataset": dataclasses.asdict(cfg.dataset),
        "experiment": dataclasses.asdict(cfg.experiment),
        "models": {"coarse": dataclasses.asdict(cfg.model_coarse)},
        "nerf": {
            "train": {**rs(cfg.nerf.train), "num_random_rays": cfg.nerf.num_random_rays},
            "validation": rs(cfg.nerf.validation),
            "use_viewdirs": cfg.nerf.use_viewdirs,
            "encode_position_fn": cfg.nerf.encode_position_fn,
            "encode_direction_fn": cfg.nerf.encode_direction_fn,
        },
        "optimizer": dataclasses.asdict(cfg.optimizer),
        "scheduler": dataclasses.asdict(cfg.scheduler),
    }
    if cfg.model_fine is not None:
        out["models"]["fine"] = dataclasses.asdict(cfg.model_fine)
    return out


def config_to_json(cfg: Config) -> str:
    """:func:`config_to_dict` plus what it leaves out (``engine``, the ``ngp``
    section, ``nerf.coarse_loss_weight`` and ``nerf.ema_decay``), as a
    JSON string that :func:`config_from_json` turns back into an equal
    Config (fixture files carry their configuration this way)."""
    d = config_to_dict(cfg)
    d["nerf"]["coarse_loss_weight"] = cfg.nerf.coarse_loss_weight
    d["nerf"]["ema_decay"] = cfg.nerf.ema_decay
    d["engine"] = cfg.engine
    if cfg.ngp is not None:
        d["ngp"] = dataclasses.asdict(cfg.ngp)
    return json.dumps(d, sort_keys=True)


def config_from_json(text: str) -> Config:
    return config_from_dict(json.loads(text))
