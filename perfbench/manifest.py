"""``BENCHMARK.json`` and the files it names, found by name.

A cell ``<config>.<traffic>`` runs the configuration file that the
manifest's ``configs`` entry names under the traffic file
``perfbench/traffic/<traffic>.json``, and is judged by
``perfbench/limits/<cell>.json``.  The configuration file's ``perfbench``
block names its architecture's two modules: ``reference``, a plain
PyTorch module under ``perfbench/reference/`` (the weights' layout, the
logits the check compares with, the model's counts), and ``adapter``, a
module under ``perfbench/adapters/`` that builds the program's model on
the drawn weights (``model_config``, ``build_lm``).  Its end-to-end
metrics are the ``end_to_end`` entries that list it (or list no cells),
each read by ``perfbench/end_to_end/<metric>.py``; its per-layer metrics
are the ``per_layer`` entries that list it, or, with no list, those whose
``moves`` metric it reports, each read by
``perfbench/per_layer/<metric>.py``.  Adding a configuration, an
architecture, a traffic mix, a cell or a metric is adding these files and
entries.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

# where a configuration's modules live, by key of its ``perfbench`` block
MODULE_DIRS = {"reference": "perfbench/reference/",
               "adapter": "perfbench/adapters/"}


@dataclasses.dataclass
class Cell:
    name: str
    config_name: str
    traffic_name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list        # manifest entries
    per_layer: list
    ref: object             # the configuration's reference module
    adapter: object         # the configuration's program adapter

    @property
    def arch(self) -> dict:
        return self.config["perfbench"]["arch"]


def load(root: Path) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def end_to_end_of(man: dict, cell: str) -> list:
    return [m for m in man["end_to_end"]
            if cell in m.get("workloads", [cell])]


def per_layer_of(man: dict, cell: str) -> list:
    moves = {m["name"] for m in end_to_end_of(man, cell)}
    return [m for m in man["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in moves)]


def module(path: Path, name: str):
    """The Python file at ``path``, loaded as a module named ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def config_module(root: Path, file: str, bench: dict, key: str):
    """The module that a configuration's ``perfbench.<key>`` names."""
    where = MODULE_DIRS[key]
    rel = bench.get(key)
    if not isinstance(rel, str) or not rel.startswith(where) \
            or not rel.endswith(".py") or ".." in rel:
        raise ValueError(
            f"{file}: perfbench.{key} must name a file {where}<name>.py "
            f"(got {rel!r}); a configuration names its reference module "
            f"and its program adapter, there is no default")
    path = Path(root) / rel
    if not path.is_file():
        raise ValueError(f"{file}: perfbench.{key} names {rel}, which is "
                         f"not there")
    return module(path, f"perfbench_{key}_{path.stem}")


def cell(root: Path, name: str) -> Cell:
    root = Path(root)
    man = load(root)
    entry = next((w for w in man["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                       f"{[w['name'] for w in man['workloads']]}")
    conf = next(c for c in man["configs"] if c["name"] == entry["config"])
    config = json.loads((root / conf["file"]).read_text())
    base = root / "perfbench"
    return Cell(
        name=name, config_name=entry["config"],
        traffic_name=entry["traffic"], chips=entry["chips"],
        config=config,
        traffic=json.loads((base / "traffic" /
                            f"{entry['traffic']}.json").read_text()),
        limits=json.loads((base / "limits" / f"{name}.json").read_text()),
        end_to_end=end_to_end_of(man, name),
        per_layer=per_layer_of(man, name),
        ref=config_module(root, conf["file"], config["perfbench"],
                          "reference"),
        adapter=config_module(root, conf["file"], config["perfbench"],
                              "adapter"))


def reader(root: Path, kind: str, metric: str):
    """``read(ctx)`` of ``perfbench/<kind>/<metric>.py``."""
    path = Path(root) / "perfbench" / kind / f"{metric}.py"
    return module(path, f"perfbench_{kind}_{metric.replace('.', '_')}").read
