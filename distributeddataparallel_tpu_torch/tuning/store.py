"""TunedConfig persistence: the autotuner's winner store.

A copy of the reference's ``tuning/store.py`` (``TuningStore``, its record
format, its atomic save and its loud field-by-field mismatch report), with
the key the port's own.  A ``TunedConfig`` record is the searched winner
for one (toolchain, devices, mesh, model config, run identity)
fingerprint, minus the tunable knobs themselves (those are the record's
payload, not its identity).  ``dpp --autotune apply`` loads the record on
a previously-tuned host and reaches its first step with zero search
trials; any key mismatch (another device count, model config, torch or
``nvcc``...) falls back LOUDLY to the CLI values — a tuned config is an
optimization, never a correctness gate.

**The key is the port's own.**  The reference's ``tuned_key`` delegates to
the XLA executable store's ``executable_key`` (jax/jaxlib/libtpu versions,
the TPU topology).  The port has no executable store (ROADMAP.md Queue 1:
serialized XLA executables have no torch counterpart), so ``tuned_key`` is
built here from ``training.warm_start.runtime_versions()`` (torch, the
CUDA runtime, ``nvcc``, the device and its capability), the device's name
and count, the mesh's axis sizes, the model config and the ``extra`` run
identity.  A record the reference wrote never matches a port key (its
``versions`` and ``topology`` fields differ), and the other way round: the
mismatch is reported field by field and ``apply`` runs on the CLI values.
``WarmStartMismatch``, ``_key_diff`` and ``_key_get`` are copies of the
reference's ``training/warm_start.py`` helpers.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Any

from distributeddataparallel_tpu_torch.utils.logging import get_logger

TUNING_STORE_VERSION = 1
_TUNED_SUFFIX = ".tuned.json"


class WarmStartMismatch(RuntimeError):
    """A stored record's key does not match the live run (strict mode)."""


def _jsonable(obj: Any):
    """A plain-JSON image of a key part (torch dtypes and other objects as
    their ``str``), so keys compare as JSON values."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        obj = dataclasses.asdict(obj)
    if isinstance(obj, dict):
        return {str(k): _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    return str(obj)


def tuned_key(
    *,
    n_devices: int,
    device_name: str,
    mesh_shape: dict | None = None,
    model_config: Any = None,
    extra: dict | None = None,
) -> dict:
    """The TunedConfig invalidation key (module docstring).

    ``mesh_shape`` is the mesh's axis sizes (``{"data": N}`` for the plain
    data-parallel runs the tuner searches).  ``extra`` carries the run
    identity the topology cannot see (model name, sequence length, param
    count, optimizer family) — NOT the tunable knobs: two runs that differ
    only in a knob the tuner owns must map to the same record, or apply
    could never find what search persisted.
    """
    from distributeddataparallel_tpu_torch.training.warm_start import runtime_versions

    key = {
        "store_version": TUNING_STORE_VERSION,
        "versions": _jsonable(runtime_versions()),
        "topology": {
            "device": device_name,
            "n_devices": int(n_devices),
            "mesh_shape": _jsonable(mesh_shape or {"data": int(n_devices)}),
        },
    }
    if model_config is not None:
        key["model_config"] = _jsonable(model_config)
    if extra:
        key["extra"] = _jsonable(extra)
    return key


def _key_diff(stored: dict, live: dict, _prefix: str = "") -> list[str]:
    """Dotted paths of every leaf where the two key dicts differ.

    Recursive, so a topology mismatch names the exact component that
    moved (``topology.n_devices``) instead of dumping the whole nested
    sub-dict as one opaque differing field.
    """
    out: list[str] = []
    for f in sorted(set(stored) | set(live)):
        a, b = stored.get(f), live.get(f)
        if a == b:
            continue
        if isinstance(a, dict) and isinstance(b, dict):
            out.extend(_key_diff(a, b, _prefix=f"{_prefix}{f}."))
        else:
            out.append(f"{_prefix}{f}")
    return out


def _key_get(key: dict, path: str):
    """Resolve a dotted ``_key_diff`` path against a nested key dict."""
    node: Any = key
    for part in path.split("."):
        if not isinstance(node, dict):
            return None
        node = node.get(part)
    return node


class TuningStore:
    """Directory of TunedConfig records, one ``<name>.tuned.json`` each.

    ``name`` is topology-scoped (``gpt2-small@d8``); ``save`` is atomic
    (tmp + rename); ``load`` verifies the FULL key dict and reports
    mismatches field-by-field before returning None (or raising,
    ``strict=True``).
    """

    def __init__(self, root: str):
        self.root = os.path.abspath(os.path.expanduser(root))
        os.makedirs(self.root, exist_ok=True)

    def path(self, name: str) -> str:
        return os.path.join(self.root, name + _TUNED_SUFFIX)

    def index(self) -> dict[str, dict]:
        """Every stored record: ``name -> record``, sorted by name."""
        out: dict[str, dict] = {}
        for fname in sorted(os.listdir(self.root)):
            if not fname.endswith(_TUNED_SUFFIX):
                continue
            name = fname[: -len(_TUNED_SUFFIX)]
            try:
                with open(os.path.join(self.root, fname)) as fh:
                    out[name] = json.load(fh)
            except (OSError, ValueError):
                continue  # half-written/corrupt records are not entries
        return out

    def save(
        self,
        name: str,
        key: dict,
        *,
        config: dict,
        objective: str,
        score: float | None,
        measured_step_s: float | None = None,
        predicted_step_s: float | None = None,
        baseline_step_s: float | None = None,
        gain_frac: float | None = None,
        trials: list | tuple = (),
    ) -> str:
        """Persist one winner; returns the record path."""
        record = {
            "version": TUNING_STORE_VERSION,
            "key": key,
            "config": dict(config),
            "objective": objective,
            "score": score,
            "measured_step_s": measured_step_s,
            "predicted_step_s": predicted_step_s,
            "baseline_step_s": baseline_step_s,
            "gain_frac": gain_frac,
            "trials": list(trials),
            "created_unix": time.time(),
        }
        path = self.path(name)
        tmp = path + ".tmp"
        with open(tmp, "w") as fh:
            fh.write(json.dumps(record, indent=1, sort_keys=True))
        os.replace(tmp, path)
        return path

    def load(self, name: str, key: dict, *, strict: bool = False):
        """The stored record when its key matches ``key``, else None
        after a LOUD field-by-field warning (``strict=True`` raises
        ``WarmStartMismatch`` instead)."""
        try:
            with open(self.path(name)) as fh:
                record = json.load(fh)
        except (OSError, ValueError):
            return None  # nothing tuned yet — a cold host, not a fault
        diff = _key_diff(record.get("key", {}), key)
        if not diff:
            return record
        stored_key = record.get("key", {})
        detail = "; ".join(
            f"{f}: stored={_key_get(stored_key, f)!r} "
            f"live={_key_get(key, f)!r}"
            for f in diff
        )
        msg = (
            f"TunedConfig '{name}' key mismatch ({detail}) — "
            "falling back to untuned defaults"
        )
        if strict:
            raise WarmStartMismatch(msg)
        get_logger().warning("%s", msg)
        return None
