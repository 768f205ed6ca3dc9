"""Find everything a cell needs by its name, from files alone.

A workload ``<config>.<traffic>`` is an entry of ``BENCHMARK.json`` at the
checkout's root. Its configuration is the file that the entry of
``configs`` names; its traffic is ``mixes/<traffic>.json``; the limits of
its comparison are ``limits/<workload>.json``; each metric that the cell
reports is read by ``metrics/<metric>.py`` (a module with ``read(rec)``).
The mix's ``mode`` names ``modes/<mode>.py``, which runs the cell, counts
its work and reads its control (``mode``); the configuration's
``route["kind"]`` names ``routes/<kind>.py``, which builds the server
(``route``). A mode may bring its own plain reference,
``reference_<name>.py``. A later cell, configuration, mix, metric, mode or
route is a new file and a new entry: no file here changes.

``systems.py`` and ``routes/`` are the only files of the harness that
import the program (``segmentation_tpu_torch``).
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Callable, Dict, List

HERE = Path(__file__).resolve().parent


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def _load(folder: str, name: str, root: Path) -> ModuleType:
    """The module ``<root>/<folder>/<name>.py`` (a name may hold dots)."""
    path = root / folder / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {path}")
    spec = importlib.util.spec_from_file_location(
        f"bench_{folder}_" + name.replace(".", "_"), path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def reader(name: str, root: Path = HERE) -> Callable[[dict], object]:
    """``read`` of ``metrics/<name>.py``."""
    return _load("metrics", name, root).read


def mode(name: str, root: Path = HERE) -> ModuleType:
    """``modes/<name>.py``: ``run(cell, seed, seconds, trace, device,
    plain) -> (rec, values)``, ``least_seconds(cfg, batch)``,
    ``unit_compute_seconds(cfg, batch)`` and ``control_row(cell, seed, rec,
    n, control_seeds, device) -> dict``."""
    return _load("modes", name, root)


def route(kind: str, root: Path = HERE) -> ModuleType:
    """``routes/<kind>.py``: ``build(cfg, params, calib, plain)``, the
    server, and ``calibration(cfg, seed, device)``, its calibration inputs
    (``[]`` where it has none)."""
    return _load("routes", kind, root)


class Cell:
    """One workload: ``cfg``, ``mix``, ``limits``, ``chips`` and its
    metrics, each (name, unit, reader), end to end and per layer."""

    def __init__(self, workload: str, root: Path = HERE):
        bench = _json(root.parent / "BENCHMARK.json")
        entries = [w for w in bench["workloads"] if w["name"] == workload]
        if not entries:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
        entry = entries[0]
        cfg_entry = [c for c in bench["configs"]
                     if c["name"] == entry["config"]][0]
        self.name, self.chips = workload, int(entry["chips"])
        self.cfg = _json(root.parent / cfg_entry["file"])
        self.mix = _json(root / "mixes" / f"{entry['traffic']}.json")
        self.limits = _json(root / "limits" / f"{workload}.json")
        self.end_to_end = self._metrics(bench["end_to_end"], root)
        self.per_layer = self._metrics(bench["per_layer"], root)
        self.run_seconds = bench["run_seconds"]

    def _metrics(self, entries: List[dict], root: Path):
        return [(m["name"], m["unit"], reader(m["name"], root))
                for m in entries if _applies(m, self.name)]


def metric_names(root: Path = HERE) -> Dict[str, List[str]]:
    """{workload: the metrics BENCHMARK.json gives it}."""
    bench = _json(root.parent / "BENCHMARK.json")
    return {w["name"]: [m["name"] for m in bench["end_to_end"]
                        + bench["per_layer"] if _applies(m, w["name"])]
            for w in bench["workloads"]}
