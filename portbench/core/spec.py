"""What a cell is, read from files: ``BENCHMARK.json`` at the root of the
checkout names the cell's configuration and traffic and lists the
metrics; ``configs/<config>.json`` holds the model as it is run,
``traffic/<traffic>.json`` the traffic mix, ``workloads/<cell>.json`` the
session settings and the limits of the correctness check.  A new cell, a
new configuration or a new traffic mix is new files and entries, never an
edit here."""

from __future__ import annotations

import dataclasses
import json
import pathlib

HERE = pathlib.Path(__file__).resolve().parents[1]  # portbench/
ROOT = HERE.parent  # the checkout


def load_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    config: dict  # configs/<config>.json
    traffic: dict  # traffic/<traffic>.json
    workload: dict  # workloads/<cell>.json
    chips: int
    end_to_end: list  # BENCHMARK.json entries this cell reports
    per_layer: list

    @property
    def model(self) -> dict:
        return self.config["model"]


def _reported(metrics: list, cell: str) -> list:
    return [m for m in metrics if cell in m.get("workloads", [cell])]


def load_cell(name: str) -> Cell:
    bench = load_json(ROOT / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json; it has "
                         f"{[w['name'] for w in bench['workloads']]}")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    return Cell(
        name=name,
        config=load_json(ROOT / conf["file"]),
        traffic=load_json(HERE / "traffic" / f"{entry['traffic']}.json"),
        workload=load_json(HERE / "workloads" / f"{name}.json"),
        chips=entry["chips"],
        end_to_end=_reported(bench["end_to_end"], name),
        per_layer=_reported(bench["per_layer"], name),
    )
