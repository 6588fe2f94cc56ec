"""The harness rehearsed on the CPU at 16^3: the cell loop through
``cell.run_cell`` (the command line itself refuses to run without a
card), the result line's keys, and cells, traffic and metrics added as
files without an edit to any file that is there."""

import hashlib
import json
import os
import re
import shutil
import subprocess
import sys

import pytest

import cell

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
TINY = {"ncoarse": 4, "npart": 16 ** 3, "boxlen": 64.0}
SEED = 2 ** 31 + 12345
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _line(result):
    """The result as the last line of standard output would carry it."""
    line = json.dumps(result)
    return json.loads(line)


@pytest.mark.parametrize("workload", ["newton512.lazy", "fr512.lazy",
                                      "newton512.eager"])
def test_cell_loop_on_cpu(workload):
    res = _line(cell.run_cell(workload, SEED, 1.0, False, "cpu",
                              overrides=TINY))
    assert {"correct", "attempted", "failed", "metrics",
            "device"} <= set(res)
    assert list(res)[-1] == "checks"
    assert res["correct"] is True
    assert res["attempted"] > 0 and res["failed"] == 0
    assert {"step_ms", "setup_s"} <= set(res["metrics"])
    for name, (value, limit) in res["checks"].items():
        assert value <= limit, name


def test_traced_cell_on_cpu():
    res = _line(cell.run_cell("fr512.lazy", SEED, 1.0, True, "cpu",
                              overrides=TINY))
    assert res["correct"] is True
    m = res["metrics"]
    assert {"ic_s", "vcycles_per_solve.fas",
            "vcycles_per_solve.poisson", "device_idle_pct"} <= set(m)
    # no kernel of the card ran: their readers report nothing
    assert not {"deposit_roofline", "gather_roofline"} & set(m)
    assert {"busy_s", "window_s"} <= set(res["device"])
    for key in ("device_ops", "idle_gaps"):
        assert len(res["breakdown"][key]) <= 10


def test_command_refuses_without_a_card():
    r = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "newton512.lazy",
         "--seed", "3", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=ROOT,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert r.returncode != 0
    assert not r.stdout.strip()


def _digest(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = hashlib.sha256(
                    fh.read()).hexdigest()
    return out


def _copy(tmp_path):
    """A copy of the benchmark without its tests: (benchmark directory,
    BENCHMARK.json as a dict, digests of every file)."""
    here = tmp_path / "benchmark"
    shutil.copytree(BENCH, here, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    return here, bench, _digest(tmp_path)


def _add_cell(tmp_path, here, bench, config: dict, name: str) -> None:
    """A configuration file and a cell of it under lazy traffic with
    newton512.lazy's limits; BENCHMARK.json gains both entries."""
    (here / "configs" / f"{name}.json").write_text(json.dumps(config))
    shutil.copy(here / "limits" / "newton512.lazy.json",
                here / "limits" / f"tiny.{name}.json")
    bench["configs"].append(dict(bench["configs"][0], name=name,
                                 file=f"benchmark/configs/{name}.json"))
    bench["workloads"].append({"name": f"tiny.{name}", "config": name,
                               "traffic": "lazy", "chips": 1,
                               "why": "rehearsal"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))


def _changed(tmp_path, before) -> set:
    after = _digest(tmp_path)
    return {k for k in before if before[k] != after.get(k)}


def _newton_config(here, **param) -> dict:
    conf = json.loads((here / "configs" / "newton_fft_cic_512.json")
                      .read_text())
    conf["param"].update(param)
    return conf


def test_new_cell_traffic_and_metric_are_files_only(tmp_path):
    here, bench, before = _copy(tmp_path)
    # a configuration, a traffic mix, a metric and a cell's limits, each a
    # new file; BENCHMARK.json gains entries
    conf = _newton_config(here, Courant_factor=0.8)
    (here / "configs" / "newton_slow_cfl.json").write_text(json.dumps(conf))
    (here / "traffic" / "every_second_sort.json").write_text(json.dumps(
        {"why": "lazy windows of one cell", "warmup_levels": [0, 1],
         "param": {"lazy_sort": True, "lazy_drift": 1}}))
    (here / "metrics" / "spans_done.py").write_text(
        "def read(ctx):\n    return float(ctx.spans)\n")
    shutil.copy(here / "limits" / "newton512.lazy.json",
                here / "limits" / "tiny.every_second_sort.json")
    bench["configs"].append(dict(
        bench["configs"][0], name="newton_slow_cfl",
        file="benchmark/configs/newton_slow_cfl.json"))
    bench["workloads"].append({"name": "tiny.every_second_sort",
                               "config": "newton_slow_cfl",
                               "traffic": "every_second_sort", "chips": 1,
                               "why": "rehearsal"})
    bench["per_layer"].append({"name": "spans_done", "unit": "spans",
                               "better": "higher", "source": "host_clock",
                               "layer": "run loop", "moves": "step_ms",
                               "workloads": ["tiny.every_second_sort"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    assert _changed(tmp_path, before) == {"BENCHMARK.json"}
    res = _line(cell.run_cell("tiny.every_second_sort", SEED, 1.0, True,
                              "cpu", overrides=TINY, here=here))
    assert res["correct"] is True
    assert "spans_done" in res["metrics"]


MODULE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "parametrized_reference.py")


@pytest.mark.parametrize("kind", ["tsc", "module"])
def test_new_configuration_is_files_only(kind, tmp_path):
    """A TSC configuration, and a configuration whose force model comes as
    its own reference module (PySCo's parametrized mu(a)), each added as
    new files: the check follows both and finds them correct."""
    here, bench, before = _copy(tmp_path)
    if kind == "tsc":
        conf = _newton_config(here, mass_scheme="TSC")
    else:
        conf = _newton_config(here, theory="parametrized",
                              parametrized_mu0=-0.1)
        conf["reference"] = "parametrized"
        shutil.copy(MODULE, here / "reference" / "parametrized.py")
    _add_cell(tmp_path, here, bench, conf, kind)
    assert _changed(tmp_path, before) == {"BENCHMARK.json"}
    res = _line(cell.run_cell(f"tiny.{kind}", SEED, 1.0, False, "cpu",
                              overrides=TINY, here=here))
    assert res["correct"] is True
    for name, (value, limit) in res["checks"].items():
        assert value <= limit, name


@pytest.mark.parametrize("source, refusal", [
    (None, "no reference module 'qumond'"),
    ("from .pm import Forces\n", "reference module 'qumond' lacks density, "
     "gather, step, power_spectrum")])
def test_module_refused_before_set_up(source, refusal, tmp_path, no_set_up):
    """A configuration whose module is missing, or lacks a callable of the
    contract, stops the run before the program's set-up."""
    here, bench, _ = _copy(tmp_path)
    conf = _newton_config(here, theory="mond",
                          linear_newton_solver="multigrid")
    conf["reference"] = "qumond"
    if source is not None:
        (here / "reference" / "qumond.py").write_text(source)
    _add_cell(tmp_path, here, bench, conf, "refused")
    with pytest.raises(SystemExit, match=re.escape(
            f"configuration 'refused': {refusal}")):
        cell.run_cell("tiny.refused", SEED, 1.0, False, "cpu",
                      overrides=TINY, here=here)


KEYS = {"": {"command", "paths", "run_seconds", "configs", "workloads",
             "end_to_end", "per_layer"},
        "configs": {"name", "source", "file", "reduced", "why"},
        "workloads": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source"},
        "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _line_of_text(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_spec_has_the_contract_form():
    bench = cell.spec()
    assert set(bench) == KEYS[""]
    for section in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in bench[section]]
        assert len(names) == len(set(names))
        for e in bench[section]:
            extra = {"workloads"} if section in ("end_to_end",
                                                 "per_layer") else set()
            assert KEYS[section] <= set(e) <= KEYS[section] | extra, e
            assert NAME.match(e["name"])
    for c in bench["configs"]:
        assert _line_of_text(c["why"]) and _line_of_text(c["source"])
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    for w in bench["workloads"]:
        assert _line_of_text(w["why"])
        assert NAME.match(w["traffic"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
    for m in bench["per_layer"]:
        assert _line_of_text(m["layer"])
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    assert all(_line_of_text(w) for w in bench["command"])
    assert len(bench["command"]) <= 32
    assert 1 <= bench["run_seconds"] <= 51


def test_spec_names_its_files():
    bench = cell.spec()
    paths = bench["paths"]
    assert paths == ["benchmark"]
    for c in bench["configs"]:
        assert NAME.match(c["name"])
        assert os.path.isfile(os.path.join(ROOT, c["file"]))
        assert c["file"].startswith("benchmark/")
    configs = {c["name"] for c in bench["configs"]}
    for w in bench["workloads"]:
        assert NAME.match(w["name"]) and w["config"] in configs
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        for d, f in (("traffic", w["traffic"] + ".json"),
                     ("limits", w["name"] + ".json")):
            assert os.path.isfile(os.path.join(BENCH, d, f))
    cells = {w["name"] for w in bench["workloads"]}
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"])
        assert os.path.isfile(os.path.join(BENCH, "metrics",
                                           m["name"] + ".py"))
        assert set(m.get("workloads", cells)) <= cells
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
