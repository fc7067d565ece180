"""Nothing the benchmark runs loads JAX or the JAX package: each module's
top-level name is compared whole (``pse_tpu_torch`` is the port)."""

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

PROBE = """
import sys, importlib, pathlib
import portbench.run as run, portbench.check, portbench.control
import portbench.reference, portbench.trace, portbench.yardstick
import pse_tpu_torch, pse_tpu_torch.api, pse_tpu_torch.integrator
for f in sorted(pathlib.Path("portbench/metrics").glob("*.py")):
    if not f.stem.startswith("_"):
        run.reader(f.stem)
bad = {m.split(".")[0] for m in sys.modules} & set(run.FORBIDDEN)
print(sorted(bad))
"""


def test_no_jax_in_the_benchmark():
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_whole_name_comparison():
    from portbench.run import FORBIDDEN

    names = {"pse_tpu_torch", "pse_tpu_torch.api", "jaxtyping"}
    assert not {m.split(".")[0] for m in names} & set(FORBIDDEN)
    assert {m.split(".")[0] for m in {"pse_tpu.api"}} & set(FORBIDDEN)


def test_no_card_no_result():
    # without a CUDA device the harness exits non-zero and prints nothing
    # on standard output
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         "phi045-n100k.blocked.forces", "--seed", "1", "--seconds", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin",
             "HOME": str(ROOT / "portbench" / "_cache")})
    assert out.returncode != 0 and out.stdout.strip() == ""
