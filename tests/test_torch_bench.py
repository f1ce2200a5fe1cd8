"""``bench_torch.py``, the port's headline benchmark, on the CPU: its
arguments, its refusal without a card, its corpus and round trip as
``bench.py``'s, and the keys of its JSON line on a KiB corpus through
``--device cpu`` (the plain versions)."""

import ast
import inspect
import json

import pytest
import torch

import bench
import bench_torch

KEYS = {"metric", "value", "unit", "vs_baseline", "baseline_mode", "encode_MiBs", "decode_MiBs",
        "rt_MiBs", "ratio", "corpus_MiB", "engine", "device", "gpu", "stages_s", "stage_calls",
        "launches", "reencoded_rows"}


def test_corpus_and_round_trip_are_bench_py_s():
    assert bench_torch.make_corpus(50_000) == bench.make_corpus(50_000)
    for fn in ("make_corpus", "run_engine"):
        assert inspect.getsource(getattr(bench_torch, fn)) == inspect.getsource(getattr(bench, fn))
    assert bench_torch.BASELINE_MIBS == pytest.approx(9.78, abs=0.005)


def test_arguments(capsys):
    with pytest.raises(SystemExit) as err:
        bench_torch.main(["--device", "tpu"])
    assert err.value.code == 2
    with pytest.raises(SystemExit) as err:
        bench_torch.main(["--help"])
    assert err.value.code == 0
    assert "--block-mib" in capsys.readouterr().out


def test_needs_a_card_unless_asked_for_the_cpu(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    assert bench_torch.main(["--mib", "0.001"]) == 2
    out = capsys.readouterr()
    assert out.out == "" and "no CUDA card" in out.err


def test_keys_on_a_kib_corpus(capsys):
    args = ["--device", "cpu", "--mib", "0.001", "--block-mib", "0.0005"]
    assert bench_torch.main(args) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert KEYS <= set(line)
    assert line["metric"] == "bz3v1_roundtrip_b0.0005_cpu"  # never a device metric
    assert line["device"] == {"platform": "cpu", "kind": "cpu", "count": 0}
    assert line["gpu"] is None and line["unit"] == "MiB/s"
    corpus = bench.make_corpus(int(0.001 * (1 << 20)))
    assert line["corpus_MiB"] == round(len(corpus) / (1 << 20), 2)
    assert line["value"] == line["rt_MiBs"] > 0
    assert line["vs_baseline"] == round(line["rt_MiBs"] / bench_torch.BASELINE_MIBS, 4)
    # the stages of one timed round trip, not the warm-up's; the plain
    # versions launch no kernel
    assert line["stage_calls"]["encode/cm"] == line["stage_calls"]["decode/cm"] == 1
    assert line["launches"] == {} and line["reencoded_rows"] == 0


def test_imports_neither_jax_nor_the_jax_side():
    with open(inspect.getsourcefile(bench_torch)) as f:
        tree = ast.parse(f.read())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    names += [n.module or "" for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)]
    assert "bzip3_tpu_torch.engines" in names
    assert not [n for n in names if n.split(".")[0] in ("jax", "jaxlib", "bzip3_tpu", "bench")]
