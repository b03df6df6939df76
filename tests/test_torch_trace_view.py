"""The port's trace viewer (``python -m repro_torch.obs.trace_view``)
against the reference's ``scripts/trace_view.py``.

One trace is exported from the port's tiny CPU engine, recorded with a
``TraceRecorder`` and a ``WallClockProfiler`` (a second one without the
profiler, which has no ``[measured]`` track).  On it the reference
script, run in-process through ``runpy`` with its standard output
captured, and the port's module give equal standard output and exit
codes in every mode: the summary, ``--validate``, ``--request`` (a known
rid and an unknown one) and ``--measured``; a trace with one broken event
fails ``--validate`` in both.
"""
import contextlib
import io
import json
import pathlib
import runpy
import sys

import pytest

from repro_torch.configs import base as tbase
from repro_torch.models.build import build_model
from repro_torch.obs import (TraceRecorder, WallClockProfiler,
                             export_chrome_trace)
from repro_torch.runtime.requests import Request, State
from test_torch_engine_paged import _drive
from test_torch_obs import t_engine

SCRIPT = pathlib.Path(__file__).resolve().parents[1] / "scripts" / \
    "trace_view.py"
CFG = dict(name="tiny", family="dense", num_layers=2, d_model=64,
           num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128,
           vocab_size=128, dtype="float32")


def _export(path, profiled: bool):
    cfg = tbase.ModelConfig(**CFG)
    api = build_model(cfg, tbase.ParallelConfig(tokenweave=True))
    eng = t_engine((api, api.init(0, device="cpu")), paged=True,
                   obs=TraceRecorder(),
                   profiler=WallClockProfiler() if profiled else None)
    _drive(eng, Request, State.DONE,
           [list(range(2, 40)), list(range(5, 29)), list(range(9, 20))],
           [4, 3, 5], {1: 2})
    path.write_text(json.dumps(export_chrome_trace(eng.obs)))
    return path


@pytest.fixture(scope="module")
def traces(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("trace_view")
    profiled = _export(tmp / "profiled.json", True)
    plain = _export(tmp / "plain.json", False)
    doc = json.loads(profiled.read_text())
    span = next(ev for ev in doc["traceEvents"] if ev.get("ph") == "X")
    span["dur"] = -1.0                       # one broken event
    broken = tmp / "broken.json"
    broken.write_text(json.dumps(doc))
    return {"profiled": profiled, "plain": plain, "broken": broken}


def _run(argv, module: bool):
    """(exit code, standard output) of one viewer run in this process."""
    out, saved = io.StringIO(), sys.argv
    sys.argv = [str(SCRIPT)] + argv
    try:
        with contextlib.redirect_stdout(out), \
                contextlib.redirect_stderr(io.StringIO()):
            try:
                if module:
                    runpy.run_module("repro_torch.obs.trace_view",
                                     run_name="__main__", alter_sys=True)
                else:
                    runpy.run_path(str(SCRIPT), run_name="__main__")
                rc = 0
            except SystemExit as e:
                rc = e.code
    finally:
        sys.argv = saved
    return rc, out.getvalue()


@pytest.mark.parametrize("trace,args,rc", [
    ("profiled", [], 0),
    ("profiled", ["--validate"], 0),
    ("profiled", ["--request", "0"], 0),
    ("profiled", ["--request", "7"], 1),
    ("profiled", ["--measured"], 0),
    ("plain", ["--measured"], 1),
    ("broken", ["--validate"], 1)])
def test_viewer_matches_reference_script(traces, trace, args, rc):
    """Equal standard output and exit codes, the exit code the mode
    gives on that trace, and output where the mode prints any."""
    argv = [str(traces[trace])] + args
    got = _run(argv, module=True)
    assert got == _run(argv, module=False)
    assert got[0] == rc
    assert bool(got[1]) == (rc == 0)
