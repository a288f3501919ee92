"""Runs one of `examples/`'s reference scripts and its PyTorch twin
(`examples/torch_<name>.py`, with `--device cpu`) side by side, each in a
process of its own, and returns what each printed. Used by the
`tests/test_torch_example_*.py` files, one file per twin."""
import os
import re
import subprocess
import sys
from pathlib import Path
from typing import NamedTuple, Sequence

ROOT = Path(__file__).resolve().parents[1]


class Printed(NamedTuple):
    returncode: int
    stdout: str
    stderr: str

    def line(self, pattern: str) -> re.Match:
        """The first printed line matching `pattern` (searched), or fail."""
        for ln in self.stdout.splitlines():
            m = re.search(pattern, ln)
            if m:
                return m
        raise AssertionError(f"no line matches {pattern!r} in:\n{self.stdout}\n{self.stderr[-2000:]}")


#: each process on few threads: the pair runs beside the suite's other
#: workers, and neither side's printed values depend on the thread count
THREADS = {"OMP_NUM_THREADS": "2", "MKL_NUM_THREADS": "2",
           "XLA_FLAGS": "--xla_cpu_multi_thread_eigen=false intra_op_parallelism_threads=2"}


def _start(script: str, args: Sequence[str], xla_flags: str = "") -> subprocess.Popen:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu", **THREADS)
    env["XLA_FLAGS"] = f"{xla_flags} {env['XLA_FLAGS']}".strip()
    return subprocess.Popen([sys.executable, str(ROOT / "examples" / script), *args], cwd=str(ROOT), env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def run_pair(name: str, args: Sequence[str] = (), timeout: float = 600, xla_flags: str = "") -> tuple:
    """(reference, twin) `Printed` of `examples/<name>.py args` and
    `examples/torch_<name>.py args --device cpu`, run at the same time;
    `xla_flags` goes before the thread flags in the reference's XLA_FLAGS
    (a script that sets its own flags sets them only when none are set)."""
    procs = [_start(f"{name}.py", args, xla_flags), _start(f"torch_{name}.py", [*args, "--device", "cpu"])]
    out = []
    for p in procs:
        try:
            stdout, stderr = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        out.append(Printed(p.returncode, stdout, stderr))
    return tuple(out)


def run_twin(name: str, args: Sequence[str] = (), timeout: float = 600) -> Printed:
    """`examples/torch_<name>.py args` alone (no `--device` added)."""
    p = _start(f"torch_{name}.py", args)
    stdout, stderr = p.communicate(timeout=timeout)
    return Printed(p.returncode, stdout, stderr)
