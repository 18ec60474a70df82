"""Config system: Hydra-compatible YAML composition without Hydra.

The PyTorch port's own copy of the JAX package's ``config.py`` (same names,
same ``configs/`` tree, same overrides), plus what the port adds: the
device that ``config.platform`` selects (``resolve_device``) and the one
log line naming the keys that only steer the JAX runtime on a TPU
(``log_ignored_keys``).

Reproduces the config surface of the reference framework
(reference conf/config.yaml:1-36, reference train.py:310-320):

* base file ``configs/config.yaml`` with a ``defaults`` list selecting a
  group file ``configs/config/<name>.yaml`` whose keys are merged into the
  ``config`` namespace;
* dotted CLI overrides ``config.KEY=VALUE`` and group selection
  ``config=<name>``;
* ``${...}`` interpolation including ``${config.*}``, ``${hydra:job.name}``
  and ``${now:%fmt}``;
* timestamped run dir ``${config.output_dir}/${job_name}-%Y-%m-%d/%H-%M-%S``
  exposed as ``config.hydra_path`` with ``.hydra/{config,overrides}.yaml``
  echo files;
* ``patch_size`` string parsing: ``"64, 64, 64"`` -> (64, 64, 64), ``"96"``
  -> 96 (reference train.py:313-320).
"""

from __future__ import annotations

import copy
import datetime
import logging
import os
import re
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import torch
import yaml


class ConfigDict(dict):
    """dict with attribute access, nested-aware (OmegaConf-lite)."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def __delattr__(self, name: str) -> None:
        try:
            del self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    @classmethod
    def wrap(cls, obj: Any) -> Any:
        if isinstance(obj, dict):
            return cls({k: cls.wrap(v) for k, v in obj.items()})
        if isinstance(obj, list):
            return [cls.wrap(v) for v in obj]
        return obj

    def to_plain(self) -> Any:
        def unwrap(o: Any) -> Any:
            if isinstance(o, dict):
                return {k: unwrap(v) for k, v in o.items()}
            if isinstance(o, (list, tuple)):
                return [unwrap(v) for v in o]
            return o

        return unwrap(self)


def _deep_merge(base: Dict, other: Dict) -> Dict:
    """Merge ``other`` into ``base`` (other wins), recursively for dicts."""
    out = dict(base)
    for k, v in other.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def _parse_value(text: str) -> Any:
    """Parse a CLI override value with YAML semantics (ints, floats, bools)."""
    try:
        return yaml.safe_load(text)
    except yaml.YAMLError:
        return text


_INTERP_RE = re.compile(r"\$\{([^${}]+)\}")


def _resolve_interpolations(tree: Dict, context: Dict[str, Any]) -> Dict:
    """Resolve ``${path.to.key}``, ``${hydra:job.name}``, ``${now:%fmt}``."""

    def lookup(path: str) -> Any:
        if path.startswith("now:"):
            return context["now"].strftime(path[len("now:"):])
        if path.startswith("hydra:"):
            key = path[len("hydra:"):]
            if key == "job.name":
                return context["job_name"]
            if key == "runtime.output_dir":
                return context["output_dir"]
            raise KeyError(f"unknown hydra interpolation: {path}")
        node: Any = tree
        for part in path.split("."):
            node = node[part]
        return node

    def resolve(value: Any, depth: int = 0) -> Any:
        if depth > 10:
            raise ValueError("interpolation recursion too deep")
        if isinstance(value, str):
            full = _INTERP_RE.fullmatch(value)
            if full:  # whole-string interpolation keeps the value's type
                return resolve(lookup(full.group(1)), depth + 1)
            return _INTERP_RE.sub(
                lambda m: str(resolve(lookup(m.group(1)), depth + 1)), value
            )
        if isinstance(value, dict):
            return {k: resolve(v, depth) for k, v in value.items()}
        if isinstance(value, list):
            return [resolve(v, depth) for v in value]
        return value

    return resolve(tree)


def parse_patch_size(value: Union[str, int, Sequence[int]]) -> Tuple[int, int, int]:
    """Normalize patch_size to a 3-tuple (reference train.py:313-320 semantics,
    then the scalar/tuple is broadcast to 3-D)."""
    if isinstance(value, str):
        parts = [p for p in value.split(",") if p.strip()]
        assert len(parts) <= 3, (
            f"patch size can only be one str or three str but got {len(parts)}"
        )
        if len(parts) == 3:
            return tuple(int(p) for p in parts)  # type: ignore[return-value]
        value = int(parts[0])
    if isinstance(value, int):
        return (value, value, value)
    value = tuple(int(v) for v in value)
    if len(value) == 1:
        return (value[0],) * 3
    assert len(value) == 3, f"patch_size must have 1 or 3 entries, got {value}"
    return value  # type: ignore[return-value]


def _default_config_dir() -> Path:
    # repo_root/configs, relative to this file: <pkg>/config.py -> repo root
    return Path(__file__).resolve().parent.parent / "configs"


def compose(
    overrides: Optional[List[str]] = None,
    job_name: str = "train",
    config_dir: Optional[Union[str, Path]] = None,
    make_run_dir: bool = True,
    now: Optional[datetime.datetime] = None,
) -> ConfigDict:
    """Compose the full config tree and return the ``config`` sub-node.

    ``overrides`` are CLI-style tokens: ``config=<group>`` or dotted
    ``config.key=value`` / ``key=value`` assignments.
    """
    overrides = list(overrides or [])
    config_dir = Path(config_dir) if config_dir else _default_config_dir()
    now = now or datetime.datetime.now()

    base_path = config_dir / "config.yaml"
    with open(base_path) as f:
        tree: Dict[str, Any] = yaml.safe_load(f) or {}

    defaults = tree.pop("defaults", [{"config": "unet"}])
    group = "unet"
    for entry in defaults:
        if isinstance(entry, dict) and "config" in entry:
            group = entry["config"]

    # group selection override comes first (config=vnet)
    assignments: List[Tuple[str, Any]] = []
    for tok in overrides:
        if "=" not in tok:
            raise ValueError(f"override must be key=value, got {tok!r}")
        key, _, raw = tok.partition("=")
        key = key.strip()
        if key == "config":
            group = raw.strip()
        else:
            assignments.append((key, _parse_value(raw)))

    group_path = config_dir / "config" / f"{group}.yaml"
    if not group_path.exists():
        raise FileNotFoundError(
            f"unknown config group 'config={group}': {group_path} not found"
        )
    with open(group_path) as f:
        group_tree = yaml.safe_load(f) or {}
    # group file keys live inside the `config` namespace (Hydra package dir)
    tree["config"] = _deep_merge(tree.get("config", {}), group_tree)

    # dotted overrides
    for key, value in assignments:
        parts = key.split(".")
        node = tree
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value

    # run-dir layout: ${config.output_dir}/${job_name}-%Y-%m-%d/%H-%M-%S
    pre = _resolve_interpolations(
        copy.deepcopy(tree),
        {"now": now, "job_name": job_name, "output_dir": ""},
    )
    hydra_cfg = tree.get("hydra", {})
    run_dir_tpl = hydra_cfg.get("run", {}).get("dir") if isinstance(hydra_cfg, dict) else None
    if run_dir_tpl is None:
        run_dir_tpl = "${config.output_dir}/${hydra:job.name}-${now:%Y-%m-%d}/${now:%H-%M-%S}"
    output_dir = _INTERP_RE.sub(
        lambda m: str(
            _resolve_one(m.group(1), pre, now, job_name)
        ),
        run_dir_tpl,
    )

    tree.pop("hydra", None)
    resolved = _resolve_interpolations(
        tree, {"now": now, "job_name": job_name, "output_dir": output_dir}
    )

    cfg = ConfigDict.wrap(resolved["config"])
    cfg.job_name = job_name
    cfg.hydra_path = output_dir
    if "patch_size" in cfg:
        cfg.patch_size = parse_patch_size(cfg.patch_size)

    if make_run_dir:
        os.makedirs(output_dir, exist_ok=True)
        hydra_dir = Path(output_dir) / ".hydra"
        hydra_dir.mkdir(exist_ok=True)
        with open(hydra_dir / "config.yaml", "w") as f:
            yaml.safe_dump({"config": cfg.to_plain()}, f, sort_keys=False)
        with open(hydra_dir / "overrides.yaml", "w") as f:
            yaml.safe_dump(overrides, f)
        # Reference run dirs carry .hydra/{config,hydra,overrides}.yaml
        # (README.md:56-66); echo the runtime facts Hydra would record.
        with open(hydra_dir / "hydra.yaml", "w") as f:
            yaml.safe_dump(
                {
                    "hydra": {
                        "run": {"dir": output_dir},
                        "job": {"name": job_name, "config_name": "config"},
                        "runtime": {
                            "output_dir": output_dir,
                            "choices": {"config": group},
                        },
                        "overrides": {"task": overrides},
                    }
                },
                f,
                sort_keys=False,
            )
    return cfg


def _resolve_one(path: str, tree: Dict, now: datetime.datetime, job_name: str) -> Any:
    if path.startswith("now:"):
        return now.strftime(path[len("now:"):])
    if path == "hydra:job.name":
        return job_name
    node: Any = tree
    for part in path.split("."):
        node = node[part]
    return node


# Keys that only steer the JAX runtime on a TPU. The port accepts them and
# names them in one log line; on CUDA the ConvBlocks always run the
# hand-written kernels, so the conv-route switches among them select nothing.
TPU_ONLY_KEYS = (
    "mesh_shape",
    "compilation_cache_dir",
    "dp_backend",
    "pallas_conv",
    "tlayout_conv",
    "tlayout_v2",
    "s2d_conv",
)


def log_ignored_keys(config, logger: logging.Logger) -> None:
    """One log line naming the TPU-only keys present in ``config``."""
    present = [k for k in TPU_ONLY_KEYS if k in config]
    if present:
        logger.info(f"ignored on this backend (TPU-only config keys): {', '.join(present)}")


def resolve_device(config) -> torch.device:
    """The device ``config.platform`` names: null, ``gpu`` or ``cuda`` mean
    the CUDA card and raise where there is none, so a broken CUDA setup never
    falls back to the CPU unnoticed; ``cpu`` means the CPU."""
    platform = getattr(config, "platform", None)
    name = None if platform is None else str(platform).lower()
    if name == "cpu":
        return torch.device("cpu")
    if name not in (None, "gpu", "cuda"):
        raise ValueError(
            f"config.platform={platform!r}: the PyTorch port runs on null, 'gpu' or 'cuda' "
            "(the CUDA card) or 'cpu'"
        )
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"config.platform={platform!r} asks for the CUDA card, but torch.cuda.is_available() "
            "is False; pass config.platform=cpu to run on the CPU"
        )
    return torch.device("cuda")
