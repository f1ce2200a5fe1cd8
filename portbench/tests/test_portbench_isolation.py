"""Nothing under portbench/ imports JAX or the JAX package, the reference
imports nothing of the program, and nothing reads the repo's older
benchmark scripts: module names compared whole by their top-level name
(``bzip3_tpu_torch`` begins with ``bzip3_tpu`` and is not it)."""

import ast
import os

import pytest

PB = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "bzip3_tpu"}
NOT_READ = ("bench.py", "bench_torch.py", "chip_smoke.py")


def sources():
    for d, _, files in os.walk(PB):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def imported(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") in (
                "import_module", "__import__") and node.args and isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", sorted(sources()), ids=lambda p: os.path.relpath(p, PB))
def test_no_jax_and_reference_standalone(path):
    tops = set(imported(path))
    assert not tops & FORBIDDEN, f"{path} imports {tops & FORBIDDEN}"
    if os.sep + "reference" + os.sep in path:
        assert "bzip3_tpu_torch" not in tops and "torch" not in tops, f"{path} imports the program"
    text = open(path).read()
    assert not any(f"open(\"{n}" in text or f"'{n}'" in text or f"\"{n}\"" in text
                   for n in NOT_READ if not path.endswith("test_portbench_isolation.py"))


def test_top_level_names_compared_whole():
    assert "bzip3_tpu_torch".split(".")[0] not in FORBIDDEN
    assert "bzip3_tpu.ops".split(".")[0] in FORBIDDEN
