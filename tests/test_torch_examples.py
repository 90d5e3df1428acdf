"""The port's examples (``examples/*_torch.py``) run on the CPU in a process
of their own, at small sizes, and load neither JAX nor the reference
package; ``dse_explore_torch.py`` prints what ``examples/dse_explore.py``
prints, line for line."""
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples"
# run an example as __main__, then fail if it loaded JAX or the reference
RUN = ("import runpy, sys\n"
       "sys.argv = sys.argv[1:]\n"
       "runpy.run_path(sys.argv[0], run_name='__main__')\n"
       "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
       "assert not bad, bad\n")


def _run(script: str, *args: str, guard: bool = True) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    cmd = ([sys.executable, "-c", RUN, str(EXAMPLES / script), *args] if guard
           else [sys.executable, str(EXAMPLES / script), *args])
    return subprocess.run(cmd, env=env, capture_output=True, text=True, timeout=300,
                          cwd=ROOT)


@pytest.mark.parametrize("script,args,expect", [
    ("quickstart_torch.py", ("--device", "cpu"), "generated 16 tokens for 4 requests"),
    ("serve_pim_torch.py", ("--device", "cpu", "--steps", "4", "--batch", "2"),
     "pooled SLC state"),
    ("dse_explore_torch.py", (), "selected plane"),
])
def test_example_runs_on_the_cpu_without_jax(script, args, expect):
    res = _run(script, *args)
    assert res.returncode == 0, res.stderr[-3000:]
    assert expect in res.stdout


def test_serve_pim_prints_every_architecture():
    res = _run("serve_pim_torch.py", "--device", "cpu", "--steps", "5", "--batch", "2")
    assert res.returncode == 0, res.stderr[-3000:]
    for arch in ("llama3-8b", "mamba2-2.7b", "deepseek-v3-671b"):
        assert f"{arch}: token agreement" in res.stdout
    assert res.stdout.count("  req ") == 6


def test_dse_explore_prints_the_reference_lines():
    port = _run("dse_explore_torch.py", "--d-model", "4096")
    ref = _run("dse_explore.py", "--d-model", "4096", guard=False)
    assert port.returncode == 0 and ref.returncode == 0, (port.stderr, ref.stderr)
    assert port.stdout.splitlines() == ref.stdout.splitlines()
    assert len(port.stdout.splitlines()) > 20


def test_examples_default_to_the_card():
    """Without ``--device cpu`` an example that runs a model targets the card
    and, on a machine without one, fails instead of falling back."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    res = _run("quickstart_torch.py")
    assert res.returncode != 0 and "device='cpu'" in res.stderr
