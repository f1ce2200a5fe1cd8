"""The port does all that the JAX package does: an inventory, read with
``ast`` from the sources of both packages (neither is imported).

For every module of ``bzip3_tpu`` and every public name of it (a
module-level function or class, a name in ``__all__``, a name an
``__init__.py`` imports, or a module-level alias ``f = g.h`` in lower
case: a function's, where an upper-case one names a constant), the port's
module of the same path must hold the same name, or ``COUNTERPARTS``
names where the port has it instead, or ``NO_COUNTERPART`` says why the
port has none.  Every entry of both lists carries its reason and must
name something that exists, so that neither list outlives the code.
"""

import ast
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX, PORT = "bzip3_tpu", "bzip3_tpu_torch"

PALLAS = "a Pallas kernel of the TPU; the port's hand-written CUDA kernel sits behind this wrapper"
PER_BLOCK = ("a single-block stage of the JAX ops/device namespace; the port's per-block stages "
             "are BlockStages (ops/device/stages.py), and its ops/device names the batched "
             "kernel wrappers")

# JAX modules whose counterpart has another path
MODULES = {
    "ops/device/cm_pallas.py": "ops/device/cm_cuda.py",
    "ops/device/crc32_pallas.py": "ops/device/crc32_cuda.py",
    "ops/device/lzp_pallas.py": "ops/device/lzp_cuda.py",
}

# (JAX module, name) -> (port module, name there, or "Class.attribute"), reason
COUNTERPARTS = {
    ("ops/device/cm_pallas.py", "cm_encode_pallas_batch"): ("ops/device/cm_cuda.py", "cm_encode", PALLAS),
    ("ops/device/cm_pallas.py", "cm_decode_pallas_batch"): ("ops/device/cm_cuda.py", "cm_decode", PALLAS),
    ("ops/device/cm_pallas.py", "cm_decode_pallas_stream"): ("ops/device/cm_cuda.py", "cm_decode_stream",
                                                             PALLAS),
    ("ops/device/crc32_pallas.py", "crc32_batch_pallas"): ("ops/device/crc32_cuda.py", "crc32_batch",
                                                           PALLAS),
    ("ops/device/crc32_pallas.py", "crc_lane_scan_pallas"): ("ops/device/crc32_cuda.py", "crc_lane_scan",
                                                             PALLAS),
    ("ops/device/lzp_pallas.py", "lzp_encode_pallas_batch"): ("ops/device/lzp_cuda.py", "lzp_encode",
                                                              PALLAS),
    ("ops/device/lzp_pallas.py", "lzp_decode_pallas_batch"): ("ops/device/lzp_cuda.py", "lzp_decode",
                                                              PALLAS),
    ("ops/device/__init__.py", "crc32_batch_pallas"): ("ops/device/__init__.py", "crc32_batch", PALLAS),
    ("ops/device/__init__.py", "lzp_encode_pallas_batch"): ("ops/device/__init__.py", "lzp_encode", PALLAS),
    ("ops/device/__init__.py", "lzp_decode_pallas_batch"): ("ops/device/__init__.py", "lzp_decode", PALLAS),
    ("ops/device/__init__.py", "crc32_batch_auto"): (
        "ops/device/__init__.py", "crc32_batch",
        "picks the Pallas kernel or the XLA scan by backend; the port's wrapper picks K4 or its "
        "plain version by the tensor's device"),
    ("ops/device/__init__.py", "cm_encode_batch"): (
        "ops/device/__init__.py", "cm_encode",
        "the batched CM encoder; the port's is the kernel wrapper (K1, K3a past one launch)"),
    ("ops/device/__init__.py", "cm_decode_batch"): (
        "ops/device/__init__.py", "cm_decode",
        "the batched CM decoder; the port's is the kernel wrapper (K2, K3b past one launch)"),
    **{("ops/device/__init__.py", n): ("ops/device/stages.py", f"BlockStages.{n}", PER_BLOCK)
       for n in ("crc32", "bwt_forward", "bwt_inverse", "rle_encode", "rle_decode")},
    ("ops/device/crc32.py", "crc32"): ("ops/device/stages.py", "BlockStages.crc32", PER_BLOCK),
}

# (JAX module, name) -> why the port has no counterpart
JIT_CORE = ("a jitted core that splits the JAX pipeline's dispatch around XLA's jit; the port has no "
            "jit to split for, its DevicePipeline runs the stages directly (encode_steps / "
            "decode_steps)")
NO_COUNTERPART = {
    **{("pipeline.py", n): JIT_CORE
       for n in ("encode_core", "encode_core_full", "encode_core_hostcrc", "decode_core",
                 "decode_core_full", "bwt_fwd_core", "bwt_inv_core")},
    **{("parallel/sharding.py", n): JIT_CORE + "; ShardedCores runs those cores over the shares"
       for n in ("sharded_encode_core", "sharded_encode_core_hostcrc", "sharded_decode_core")},
    ("parallel/multihost.py", "make_global_batch"): (
        "builds one jax.Array over the processes of a job; PyTorch has no array over processes, "
        "so the port's ranks each code their own stripe of blocks and gather_to_writer brings the "
        "rows to rank 0"),
}


def _modules(pkg: str) -> list[str]:
    base = os.path.join(ROOT, pkg)
    out = []
    for root, _, files in os.walk(base):
        out += [os.path.relpath(os.path.join(root, f), base).replace(os.sep, "/")
                for f in files if f.endswith(".py")]
    return sorted(out)


def _tree(pkg: str, module: str) -> ast.Module:
    with open(os.path.join(ROOT, pkg, module)) as f:
        return ast.parse(f.read())


def public_names(pkg: str, module: str) -> set[str]:
    """A module's public names, read from its source."""
    init = module.endswith("__init__.py")
    names = set()
    for node in _tree(pkg, module).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.ImportFrom) and init:
            names |= {a.asname or a.name for a in node.names}
        elif isinstance(node, ast.Assign):
            for tgt in node.targets:
                if isinstance(tgt, ast.Name) and tgt.id == "__all__":
                    names |= {e.value for e in node.value.elts}
                else:  # aliases, one or a tuple of them
                    pairs = (zip(tgt.elts, node.value.elts) if isinstance(tgt, ast.Tuple)
                             and isinstance(node.value, ast.Tuple) else [(tgt, node.value)])
                    names |= {t.id for t, v in pairs if isinstance(t, ast.Name) and t.id.islower()
                              and isinstance(v, (ast.Name, ast.Attribute))}
    return {n for n in names if not n.startswith("_")}


def _class_attrs(pkg: str, module: str, cls: str) -> set[str]:
    """Methods of ``cls`` and the attributes its methods set on ``self``."""
    for node in _tree(pkg, module).body:
        if isinstance(node, ast.ClassDef) and node.name == cls:
            attrs = {n.name for n in node.body if isinstance(n, ast.FunctionDef)}
            attrs |= {t.attr for t in ast.walk(node) if isinstance(t, ast.Attribute)
                      and isinstance(t.value, ast.Name) and t.value.id == "self"
                      and isinstance(t.ctx, ast.Store)}
            return attrs
    return set()


def _port_has(module: str, name: str) -> bool:
    if not os.path.exists(os.path.join(ROOT, PORT, module)):
        return False
    if "." in name:
        cls, attr = name.split(".")
        return attr in _class_attrs(PORT, module, cls)
    return name in public_names(PORT, module)


JAX_MODULES = _modules(JAX)


def test_the_inventory_reads_both_packages():
    assert len(JAX_MODULES) >= 30 and "ops/ref/cm.py" in JAX_MODULES
    assert {"NativeCodec", "crc32", "rle_encode", "bwt_inverse"} <= public_names(
        PORT, "ops/native/__init__.py")
    assert {"crc32", "lzp_encode", "cm_decode"} <= _class_attrs(PORT, "ops/device/stages.py",
                                                               "BlockStages")


@pytest.mark.parametrize("module", JAX_MODULES)
def test_every_jax_module_has_a_counterpart(module):
    port = MODULES.get(module, module)
    assert os.path.exists(os.path.join(ROOT, PORT, port)), f"{PORT}/{port} is missing"
    missing = []
    for name in sorted(public_names(JAX, module)):
        if (module, name) in NO_COUNTERPART:
            continue
        where, there, _ = COUNTERPARTS.get((module, name), (port, name, ""))
        if not _port_has(where, there):
            missing.append(f"{name} (looked for {there} in {where})")
    assert missing == [], f"{module}: no counterpart in the port for {missing}"


@pytest.mark.parametrize("table", ["COUNTERPARTS", "NO_COUNTERPART"])
def test_every_entry_is_live_and_has_a_reason(table):
    entries = globals()[table]
    for (module, name), val in entries.items():
        reason = val[2] if table == "COUNTERPARTS" else val
        assert module in JAX_MODULES and name in public_names(JAX, module), (module, name)
        assert isinstance(reason, str) and len(reason) > 20, (module, name)
        assert (module, name) not in (NO_COUNTERPART if table == "COUNTERPARTS" else COUNTERPARTS)
        if table == "NO_COUNTERPART":  # truly absent: else it belongs in COUNTERPARTS
            assert not _port_has(MODULES.get(module, module), name), (module, name)
    for module, port in MODULES.items():
        assert module.endswith("_pallas.py") and port.endswith("_cuda.py")
        assert not os.path.exists(os.path.join(ROOT, PORT, module))
