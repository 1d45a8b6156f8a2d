"""What the benchmark loads: no JAX and no JAX package anywhere, and
nothing of the program in the reference and the work counts."""
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
FORBIDDEN = {"jax", "jaxlib", "flax", "ppyolo_tpu"}


def loaded(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\n"
                          "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))"],
                         cwd=ROOT, capture_output=True, text=True, check=True)
    return set(out.stdout.split())


def test_the_benchmark_loads_no_jax_and_no_jax_package():
    mods = loaded(
        "from benchmark import run\n"
        "from benchmark.harness import serve, train, trace, traffic, weights, card, faults, ranks\n"
        "from benchmark.tools import control\n"
        "from benchmark.work import counts\n"
        "run.readers()\n"
        "import ppyolo_tpu_torch.eval.detector, ppyolo_tpu_torch.train.loop\n"
        "import ppyolo_tpu_torch.data.loader, ppyolo_tpu_torch.parallel.dist")
    assert "ppyolo_tpu_torch" in mods
    assert not mods & FORBIDDEN, mods & FORBIDDEN


def test_the_reference_imports_nothing_of_the_program():
    mods = loaded("from benchmark.reference import model, train, compare, common\n"
                  "from benchmark.work import counts")
    assert not mods & (FORBIDDEN | {"ppyolo_tpu_torch"})


def test_forbidden_names_compare_whole_module_names():
    from benchmark import run

    sys.modules.setdefault("ppyolo_tpu_torch_lookalike", sys)   # shares the prefix
    try:
        assert "ppyolo_tpu" not in run.forbidden_modules()
    finally:
        del sys.modules["ppyolo_tpu_torch_lookalike"]
