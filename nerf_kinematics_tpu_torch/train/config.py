"""One dataclass-based config system accepting the reference YAML schema
verbatim: sections ``dataset / experiment / models / nerf / optimizer /
scheduler`` plus ``engine`` and ``ngp``.

``yaml`` is imported inside :func:`load_config` only: machines without
PyYAML still run everything that starts from a dict or a fixture.
"""

from __future__ import annotations

import dataclasses
import json
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
    """Load a reference-schema YAML config file."""
    import yaml

    with open(path, "r") as f:
        return config_from_dict(yaml.safe_load(f))


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
