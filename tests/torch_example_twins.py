"""What the example twins (tests/test_torch_example_*.py) share: the
reference example run as a user runs it, its printed lines parsed, and
the serving twins' top-2 margin rule for tokens."""
import ast
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
MARGIN = 1e-3            # tests/test_torch_serving.py's near-tie margin


def run_reference(name, timeout=600):
    """The reference ``examples/<name>.py`` in a Python of its own on the
    CPU: its stdout's lines (it must exit 0)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, str(ROOT / "examples" / name)],
                          env=env, cwd=ROOT, capture_output=True, text=True,
                          timeout=timeout)
    assert proc.returncode == 0, proc.stdout + proc.stderr[-4000:]
    return proc.stdout.splitlines()


def parsed(lines, pattern):
    """``{int(group 1): literal_eval(group 2)}`` of the lines matching
    ``pattern``."""
    out = {}
    for line in lines:
        m = re.search(pattern, line)
        if m:
            out[int(m.group(1))] = ast.literal_eval(m.group(2))
    return out


def literal_after(lines, prefix):
    """The Python literal that follows ``prefix`` on the first line
    starting with it (up to its closing bracket)."""
    for line in lines:
        if line.startswith(prefix):
            rest = line[len(prefix):].strip()
            close = {"{": "}", "[": "]"}[rest[0]]
            return ast.literal_eval(rest[:rest.index(close) + 1])
    raise AssertionError(f"no line starts with {prefix!r}")


def margin(logits) -> float:
    top = np.sort(np.asarray(logits))[-2:]
    return float(top[1] - top[0])


def assert_tokens_match(got, want, logits, offset=0):
    """Each request's tokens equal the reference's, step by step, until a
    step whose top-2 logit margin (the port's; the packages' logits agree
    within 1e-4) is under MARGIN: a tie that close may break either way,
    and the request's later tokens follow from it, so they are not
    compared. ``offset`` tokens of a request precede its logit trace (a
    fork's copied ones). Returns the number of requests cut short."""
    assert set(got) == set(want)
    cut = 0
    for rid, ref in want.items():
        mine = got[rid]
        assert len(mine) == len(ref), (rid, mine, ref)
        for t, (a, b) in enumerate(zip(mine, ref)):
            if t >= offset and margin(logits[rid][t - offset]) < MARGIN:
                print(f"request {rid} step {t}: near tie, not compared on")
                cut += 1
                break
            assert a == b, (rid, t, mine, ref)
    return cut
