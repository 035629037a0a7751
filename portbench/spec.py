"""The benchmark's files, found by name, and the character rules they keep.

``BENCHMARK.json`` at the root of the checkout lists the cells and the
metrics. Everything that belongs to one of them is a file of its own under
this folder, named after it:

- ``configs/<config>.json``: a configuration (the program's settings and the
  shapes, with its ``source``, ``assumed`` and ``reduced``), named by a
  cell's ``config``;
- ``traffic/<traffic>.json``: a traffic mix, named by a cell's ``traffic``:
  the ``driver`` that offers it and that driver's parameters;
- ``drivers/<driver>.py``: a driver, shared by every mix that names it;
- ``workloads/<cell>.json``: how a cell's answers are checked (which units
  keep them, the tolerances, the limits of the comparison);
- ``metrics/<metric>.py``: a metric's reader, with its ``UNIT``, its
  ``LAYER`` (None for an end-to-end metric) and the end-to-end metric it
  ``MOVES``.

A cell's entry in ``BENCHMARK.json`` is the one place that names its
configuration and its mix. Adding a cell, a configuration, a mix or a metric
is adding files (and entries in ``BENCHMARK.json``); no file here needs an
edit.
"""
from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}")


class SpecError(ValueError):
    """A file of the benchmark breaks its rules or cannot be found."""


def check_name(name, what: str) -> str:
    if not isinstance(name, str) or not NAME.fullmatch(name):
        raise SpecError(f"{what} {name!r} breaks the name rule "
                        "(a letter, digit or _, then up to 63 of A-Z a-z 0-9 _ . -)")
    return name


def check_unit(unit, what: str) -> str:
    if not isinstance(unit, str) or not UNIT.fullmatch(unit):
        raise SpecError(f"unit {unit!r} of {what} breaks the unit rule "
                        "(1 to 16 of A-Z a-z 0-9 _ / % . -)")
    return unit


def _load_json(path: Path) -> dict:
    try:
        with open(path) as f:
            return json.load(f)
    except FileNotFoundError:
        raise SpecError(f"{path.relative_to(ROOT) if path.is_relative_to(ROOT) else path} "
                        "is missing") from None


def benchmark(root: Path = ROOT) -> dict:
    """``BENCHMARK.json`` with every name and unit checked."""
    spec = _load_json(root / "BENCHMARK.json")
    for c in spec["configs"]:
        check_name(c["name"], "config")
        for key in c["reduced"]:
            check_name(key, f"reduced key of {c['name']}")
    for w in spec["workloads"]:
        check_name(w["name"], "workload")
        check_name(w["config"], f"config of {w['name']}")
        check_name(w["traffic"], f"traffic of {w['name']}")
    for group in ("end_to_end", "per_layer"):
        for m in spec[group]:
            check_name(m["name"], "metric")
            check_unit(m["unit"], m["name"])
    return spec


def workload(name: str, base: Path = HERE) -> dict:
    return _load_json(base / "workloads" / f"{check_name(name, 'workload')}.json")


def config(name: str, base: Path = HERE) -> dict:
    return _load_json(base / "configs" / f"{check_name(name, 'config')}.json")


def traffic(name: str, base: Path = HERE) -> dict:
    return _load_json(base / "traffic" / f"{check_name(name, 'traffic')}.json")


def load_module(path: Path, name: str):
    """Import a file of this folder by path (metric files carry dots in
    their names)."""
    if not path.exists():
        raise SpecError(f"{path} is missing")
    mod_spec = importlib.util.spec_from_file_location(f"portbench_{name}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


def metric(name: str, base: Path = HERE):
    """The reader of metric ``name``, its unit checked."""
    mod = load_module(base / "metrics" / f"{check_name(name, 'metric')}.py", name)
    check_unit(mod.UNIT, name)
    return mod


def driver(name: str, base: Path = HERE):
    return load_module(base / "drivers" / f"{check_name(name, 'driver')}.py", name)


def build(cell: dict, seed: int, device, base: Path = HERE):
    """(driver, configuration, mix, checks) of ``cell``, an entry of
    ``BENCHMARK.json``: the driver built on the other three, its inputs
    made from ``seed``."""
    cfg, mix = config(cell["config"], base), traffic(cell["traffic"], base)
    check = workload(cell["name"], base)
    return driver(mix["driver"], base).Driver(cfg, mix, check, seed, device), cfg, mix, check


def cell_metrics(spec: dict, cell: str) -> tuple[list[dict], list[dict]]:
    """The end-to-end and the per-layer metrics that ``cell`` reports: an
    end-to-end metric without ``workloads`` is reported everywhere; a
    per-layer metric without it wherever the metric it moves is."""
    e2e = [m for m in spec["end_to_end"] if cell in m.get("workloads", [cell])]
    names = {m["name"] for m in e2e}
    layer = [m for m in spec["per_layer"]
             if (cell in m["workloads"] if "workloads" in m else m["moves"] in names)]
    return e2e, layer
