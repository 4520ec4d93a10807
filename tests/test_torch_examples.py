"""The port's example twins (``examples/torch_*.py``) with ``--device cpu``,
each in a subprocess with one intra-op thread, against the reference's
examples run in the same test.

For ``quickstart``, ``bnb_dive`` and ``presolve_service`` the twin's lines
must equal the reference example's after this filter (:func:`untimed`):
  * dropped lines: those that carry a time in ms (``... nodes in 937.9 ms
    -> 2794 nodes/sec``, ``served ... ms wall (... instances/sec ...)``,
    ``latency p50=...ms ...``);
  * dropped fields: the set-up time ``in 9.6s`` of ``service up``, the
    ``mean occupancy=`` of the service's stats line (it depends on the
    arrival timing) and the speed ratio ``is 0.5x on nodes/sec`` of
    ``bnb_dive``'s summary;
  * quickstart's ``block_ell_runner`` cache line: the reference caches a
    compiled fixed-point runner, the port runs eagerly and has none to
    count (the twin says so on that line).
Every other line -- bounds, rounds, flags, search counts, incumbents,
telemetry levels, bucket shapes, engine-cache counts and the presolve
table -- must be equal.  ``serve_lm``'s twin draws its weights from another
generator, so its test checks the format, the shapes and the exit code.
"""
import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
TWINS = ["quickstart", "bnb_dive", "presolve_service"]


def _start(script: str, *args: str) -> subprocess.Popen:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1",
               JAX_PLATFORMS="cpu")
    return subprocess.Popen([sys.executable, str(ROOT / "examples" / script), *args],
                            cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _finish(proc: subprocess.Popen, timeout: float = 240.0) -> str:
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        raise
    assert proc.returncode == 0, err[-4000:]
    return out


_DROP_LINE = re.compile(r"\d ms\b|ms wall|latency p50=|block_ell_runner:")
_FIELDS = [
    (re.compile(r"service up in [0-9.]+s:"), "service up:"),
    (re.compile(r"mean occupancy=[0-9.]+ "), ""),
    (re.compile(r"device-resident search is [0-9.]+x on nodes/sec here"),
     "device-resident search is <ratio> on nodes/sec here"),
]


def untimed(text: str) -> list:
    lines = []
    for line in text.splitlines():
        if _DROP_LINE.search(line):
            continue
        for pattern, repl in _FIELDS:
            line = pattern.sub(repl, line)
        lines.append(line)
    return lines


def test_example_twins_print_the_reference_lines():
    # All seven processes at once: the twins and the reference's examples.
    procs = {(name, side): _start(f"torch_{name}.py" if side == "port" else f"{name}.py",
                                  *(["--device", "cpu"] if side == "port" else []))
             for name in TWINS for side in ("port", "reference")}
    outs = {key: _finish(proc) for key, proc in procs.items()}
    for name in TWINS:
        got, want = untimed(outs[name, "port"]), untimed(outs[name, "reference"])
        assert len(want) > 5, (name, want)
        assert got == want, (name, got, want)
    assert "bounds match: True" in outs["quickstart", "port"]
    assert "same optimum" in outs["bnb_dive", "port"]
    assert "block_ell_runner: none" in outs["quickstart", "port"]


def test_serve_lm_twin():
    out = _finish(_start("torch_serve_lm.py", "--device", "cpu"))
    lines = out.splitlines()
    archs = [("qwen2-0.5b", "dense"), ("recurrentgemma-9b", "hybrid"), ("mamba2-780m", "ssm")]
    assert len(lines) == len(archs), lines
    for line, (arch, family) in zip(lines, archs):
        m = re.fullmatch(
            rf"{re.escape(arch)} +\({family} *\): generated \(4, 24\) tokens in "
            r"[0-9.]+s -- sample: \[((?:\d+, ){9}\d+)\]", line)
        assert m, line
        assert all(0 <= int(t) < 256 for t in m.group(1).split(", "))  # padded SMOKE vocab
