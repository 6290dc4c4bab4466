"""The paper's figures on the port (``repro_torch.figures``) against the
reference's figure drivers (``benchmarks/``), on the CPU.

Each driver's declared points equal the reference module's, in quick and
full mode (the reference fixes its kernel lists when it is imported, so it
is imported under each mode in a subprocess).  The rows and summaries of
``motivation``, Figs. 13, 15, 16 and 17 (its §3.4 profile on the CPU
route) equal the reference's letter for letter on two cheap kernels, each
package sweeping inline into its own temporary store.  Then the port's
own surfaces: ``figures.run.main`` writes only its summary and the port's
store, ``scripts/torch_sweep_service.py --grid quick`` takes the figures'
quick union, and ``scripts/torch_chaos_drill.py`` passes one classic and
one elastic drill.
"""
import dataclasses
import importlib.util
import json
import os
import pathlib
import subprocess
import sys

import pytest

from repro.core.cgra import sweep as ref_sw
from repro_torch.core.cgra import presets
from repro_torch.core.cgra import sweep as sw
from repro_torch.figures import (common, fig11_exec_time, fig12_cache_sweeps,
                                 fig13_runahead, fig14_mshr, fig15_accuracy,
                                 fig16_coverage, fig17_reconfig,
                                 fig18_frontier, motivation, run)

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:       # the reference's ``benchmarks`` package
    sys.path.append(str(ROOT))

from benchmarks import common as ref_common  # noqa: E402
from benchmarks import fig13_runahead as ref_fig13  # noqa: E402
from benchmarks import fig15_accuracy as ref_fig15  # noqa: E402
from benchmarks import fig16_coverage as ref_fig16  # noqa: E402
from benchmarks import fig17_reconfig as ref_fig17  # noqa: E402
from benchmarks import motivation as ref_motivation  # noqa: E402

DRIVERS = {"motivation": motivation, "fig11_exec_time": fig11_exec_time,
           "fig12_cache_sweeps": fig12_cache_sweeps,
           "fig13_runahead": fig13_runahead, "fig14_mshr": fig14_mshr,
           "fig15_accuracy": fig15_accuracy, "fig16_coverage": fig16_coverage,
           "fig17_reconfig": fig17_reconfig,
           "fig18_frontier": fig18_frontier}
CHEAP = ["gcn_cora", "rgb"]

_REF_POINTS = """
import dataclasses, json, sys
sys.path.insert(0, sys.argv[1])
import importlib
out = {}
for name in json.loads(sys.argv[2]):
    mod = importlib.import_module("benchmarks." + name)
    out[name] = [[k, dataclasses.asdict(c)] for k, c in mod.points()]
print(json.dumps(out))
"""


def _as_json(points) -> list:
    return json.loads(json.dumps([[k, dataclasses.asdict(c)]
                                  for k, c in points]))


@pytest.fixture(scope="module")
def ref_points():
    """Each reference driver's ``points()``, imported under each mode."""
    out = {}
    for quick in (False, True):
        env = {k: v for k, v in os.environ.items()
               if k != "REPRO_BENCH_QUICK"}
        if quick:
            env["REPRO_BENCH_QUICK"] = "1"
        env["PYTHONPATH"] = str(ROOT / "src")
        proc = subprocess.run(
            [sys.executable, "-c", _REF_POINTS, str(ROOT),
             json.dumps(list(DRIVERS))], env=env, capture_output=True,
            text=True, timeout=120, check=True)
        out[quick] = json.loads(proc.stdout)
    return out


@pytest.mark.parametrize("quick", [False, True], ids=["full", "quick"])
@pytest.mark.parametrize("name", list(DRIVERS))
def test_points_equal_the_references(ref_points, name, quick):
    got = _as_json(DRIVERS[name].points(quick))
    assert got and got == ref_points[quick][name]


def test_sweep_union_is_the_references(ref_points):
    """The union, in order and deduplicated, as ``benchmarks.run``'s."""
    for quick in (False, True):
        want = []
        for name in DRIVERS:
            want += [json.dumps(p, sort_keys=True)
                     for p in ref_points[quick][name]]
        got = [json.dumps(p, sort_keys=True)
               for p in _as_json(run.sweep_points(quick))]
        assert got == list(dict.fromkeys(want))


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    root = tmp_path_factory.mktemp("figure_stores")
    return sw.SimCache(root / "port"), ref_sw.SimCache(root / "ref")


@pytest.fixture
def cheap(monkeypatch, stores):
    """Both packages on ``gcn_cora`` and ``rgb``, inline, each into its own
    temporary store, with empty memos."""
    monkeypatch.setenv("REPRO_SWEEP_WORKERS", "0")
    monkeypatch.setattr(common, "PAPER_KERNELS", list(CHEAP))
    monkeypatch.setattr(ref_common, "PAPER_KERNELS", list(CHEAP))
    monkeypatch.setattr(ref_fig17, "KERNELS", list(CHEAP))
    monkeypatch.setattr(ref_common, "STORE", stores[1])
    monkeypatch.setattr(ref_common, "_stats", {})
    monkeypatch.setattr(ref_common, "_meta", {})
    common.reset(stores[0])
    yield
    common.reset()


def _rows(capsys) -> list[str]:
    return capsys.readouterr().out.splitlines()


@pytest.mark.parametrize("port,ref", [
    (motivation, ref_motivation), (fig13_runahead, ref_fig13),
    (fig15_accuracy, ref_fig15), (fig16_coverage, ref_fig16),
    (fig17_reconfig, ref_fig17)], ids=lambda m: m.__name__.split(".")[-1])
def test_rows_and_summary_equal_the_references(cheap, capsys, port, ref):
    want = ref.run()
    want_rows = _rows(capsys)
    got = port.run(False, device="cpu")
    got_rows = _rows(capsys)
    assert len(got_rows) > len(CHEAP) and got_rows == want_rows
    assert got == want


def test_fig17_reconfigures_on_the_requested_device(cheap, monkeypatch):
    """The §3.4 profile takes ``device`` through ``reconfigure_cached``;
    without one it asks for the card, which raises here (no fallback)."""
    monkeypatch.setattr(common, "PAPER_KERNELS", ["rgb"])
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        fig17_reconfig.run(False)
    seen = []
    real = sw.reconfigure_cached

    def spy(*a, **k):
        seen.append(k["device"])
        return real(*a, **k)
    monkeypatch.setattr(sw, "reconfigure_cached", spy)
    fig17_reconfig.run(False, device="cpu")
    assert seen == ["cpu"]


def test_main_writes_only_its_summary_and_the_ports_store(
        cheap, monkeypatch, tmp_path, capsys):
    """On a reduced union (two Table-1 kernels, one frontier kernel),
    ``main`` prints every figure's rows and writes its summary under
    ``artifacts/figures_torch/`` and results in the port's store, and
    nothing of the reference's: no ``BENCH_sim.json``, no
    ``bench_summary.json``, no reference store."""
    monkeypatch.setattr(fig18_frontier, "KERNELS", ["hash_join_uniform"])
    monkeypatch.delenv("REPRO_BENCH_QUICK", raising=False)
    store = tmp_path / "artifacts" / "simcache_torch"
    summary = tmp_path / "artifacts" / "figures_torch" / "summary.json"
    monkeypatch.setenv("REPRO_TORCH_SIMCACHE", str(store))
    monkeypatch.setenv("REPRO_SIMCACHE", str(tmp_path / "ref_store"))
    monkeypatch.setattr(run, "SUMMARY", summary)
    common.reset()
    bench_sim = (ROOT / "BENCH_sim.json").read_bytes()
    bench_summary = ROOT / "artifacts" / "bench_summary.json"
    before = bench_summary.stat().st_mtime_ns if bench_summary.exists() \
        else None
    monkeypatch.chdir(tmp_path)
    assert run.main(["--device", "cpu"]) == 0
    rows = _rows(capsys)
    assert rows[0] == "name,us_per_call,derived"
    assert rows[-1].startswith("total_figure_seconds,")
    for prefix in ("fig2_spm_only_4k/", "fig11a/", "fig12f/", "fig13/",
                   "fig14/", "fig15/", "fig16/", "fig17/", "fig18/"):
        assert any(r.startswith(prefix) for r in rows), prefix
    written = {p.relative_to(tmp_path).parts[:2]
               for p in tmp_path.rglob("*") if p.is_file()}
    assert written == {("artifacts", "figures_torch"),
                       ("artifacts", "simcache_torch")}
    doc = json.loads(summary.read_text())
    assert doc["sweep_points"] == len(run.sweep_points(False))
    assert doc["device"] == "cpu" and doc["quick"] is False
    assert doc["sweep_report"]["points"] > 0 and not doc["failures"]
    assert set(doc["fig18"]) == {"hash_join_uniform"}
    assert (ROOT / "BENCH_sim.json").read_bytes() == bench_sim
    assert (bench_summary.stat().st_mtime_ns if bench_summary.exists()
            else None) == before


def _script(name: str):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_sweep_service_quick_grid_is_the_figures_quick_union():
    service = _script("torch_sweep_service")
    assert service.grid_points("quick") == run.sweep_points(quick=True)
    assert len(service.grid_points("demo")) == 12
    with pytest.raises(SystemExit, match="demo|quick"):
        service.grid_points("full")


_DRILL = """
import sys
sys.path.insert(0, sys.argv[1] + "/scripts")
sys.path.insert(0, sys.argv[1] + "/src")
import torch_chaos_drill as drill
from repro_torch.core.cgra import presets
drill.quick_points = lambda: [
    (k, c) for k in ("gcn_cora", "rgb")
    for c in (presets.CACHE_SPM, presets.RUNAHEAD, presets.SPM_ONLY_4K)]
sys.exit(drill.main(sys.argv[2:]))
"""


@pytest.mark.parametrize("profile,timeout", [("workercrash", 240),
                                             ("tornjournal", 300)])
def test_chaos_drill_passes(tmp_path, profile, timeout):
    """One classic drill (worker crashes on a few monkeypatched points of
    the quick grid) and one elastic drill (a worker killed after 5 durable
    points of the demo grid, its journal torn, a relaunch resuming), each
    in a subprocess under its own timeout."""
    proc = subprocess.run(
        [sys.executable, "-c", _DRILL, str(ROOT), "--profiles", profile,
         "--seed", "20260808"], cwd=ROOT, capture_output=True, text=True,
        timeout=timeout, env={**os.environ,
                              "PYTHONPATH": str(ROOT / "src"),
                              "TMPDIR": str(tmp_path)})
    line = [x for x in proc.stdout.splitlines()
            if x.startswith(f"chaos_drill[{profile}")]
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert len(line) == 1 and "]: ok " in line[0], proc.stdout
    counters = dict(kv.split("=") for kv in line[0].split(") ")[1].split())
    if profile == "workercrash":
        assert int(counters["crashes"]) >= 1 and \
            int(counters["quarantined"]) == 0
    else:
        assert int(counters["relaunches"]) >= 1 and \
            int(counters["resumed"]) >= 1
