"""The architecture seam: a configuration's ``model_type`` names
``bench/archs/<type>.py`` and ``bench/reference/<type>.py``, a missing
one is named in the error, a new architecture loads from new files
alone, and the Llama modules draw and compute exactly what the harness
drew and computed before its Llama code moved into them
(``golden_llama.json``: each tensor's dtype, shape and sha256, recorded
from that harness at the tiny configurations)."""
import hashlib
import json
import shutil

import pytest
import torch

import bench_tiny_cells as tiny
from bench_tiny_cells import one_thread  # noqa: F401 (an autouse fixture)
from harness import arch, spec
from reference import model as ref_model

GOLDEN = json.loads((tiny.BENCH / "tests" / "golden_llama.json").read_text())
SEED = 2**33 + 29
CONFS = {"dense": tiny.DENSE, "mha": tiny.MHA}
#: what a harness-side module and a reference module supply
HARNESS = ("dims", "arch_config", "draw_model", "published_layer",
           "published_head")
REFERENCE = ("layer", "logits")


def digest(t):
    t = t.detach().contiguous().cpu()
    return f"{str(t.dtype).removeprefix('torch.')} {list(t.shape)} " \
        + hashlib.sha256(t.reshape(-1).view(torch.uint8).numpy()
                         .tobytes()).hexdigest()


def flat(tree, prefix=""):
    out = {}
    items = enumerate(tree) if isinstance(tree, list) else tree.items()
    for k, v in items:
        if isinstance(v, (dict, list)):
            out.update(flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = digest(v)
    return out


def drawn(conf, part):
    a = arch.load(conf)
    m = a.harness.dims(conf)
    if part == "draw_model":
        return flat(a.harness.draw_model(m, SEED, "cpu"))
    if part == "published":
        out = flat(a.harness.published_head(m, SEED, "cpu"), "head.")
        for i in range(m["layers"]):
            out.update(flat(a.harness.published_layer(m, SEED, i, "cpu"),
                            f"layers.{i}."))
        return out
    tokens = torch.arange(45) * 37 % m["vocab"]
    return {"logits": digest(ref_model.replay(
        a.reference, m, {"r": tokens}, {"r": list(range(45))},
        lambda i: a.harness.published_layer(m, SEED, i, "cpu"),
        lambda: a.harness.published_head(m, SEED, "cpu"))["r"])}


@pytest.mark.parametrize("part", ["draw_model", "published", "logits"])
@pytest.mark.parametrize("name", sorted(CONFS))
def test_llama_draws_what_the_harness_drew(name, part):
    """Every leaf of the program's layout and of the published views,
    and the reference's logits over one fixed sequence, bit for bit."""
    assert drawn(CONFS[name], part) == GOLDEN[name][part]


def test_llama_supplies_the_interface():
    a = arch.load(tiny.DENSE)
    assert all(callable(getattr(a.harness, f)) for f in HARNESS)
    assert all(callable(getattr(a.reference, f)) for f in REFERENCE)
    m = a.harness.dims(tiny.DENSE)
    assert m["model_type"] == "llama" and m["layer_params"] > 0


def test_unknown_model_type_names_both_files():
    with pytest.raises(ValueError) as e:
        arch.load(dict(tiny.DENSE, model_type="mamba"))
    assert "bench/archs/mamba.py" in str(e.value)
    assert "bench/reference/mamba.py" in str(e.value)


def test_qwen3_needs_only_its_harness_side(tmp_path):
    """The plain Qwen3 forward is committed; a Qwen3 configuration needs
    ``bench/archs/qwen3.py`` and nothing else of code.  Held on a copy
    of the benchmark's architectures without that file, so that it holds
    before and after the file is added."""
    bench = tmp_path / "bench"
    shutil.copytree(tiny.BENCH / "reference", bench / "reference")
    shutil.copytree(tiny.BENCH / "archs", bench / "archs")
    (bench / "archs" / "qwen3.py").unlink(missing_ok=True)
    with pytest.raises(ValueError) as e:
        arch.load(dict(tiny.DENSE, model_type="qwen3"), bench=bench)
    assert "bench/archs/qwen3.py" in str(e.value)
    assert "reference/qwen3.py" not in str(e.value)
    plain = spec.module(tiny.BENCH / "reference" / "qwen3.py",
                        "bench_reference")
    assert all(callable(getattr(plain, f)) for f in REFERENCE)


def test_a_new_architecture_is_new_files(tmp_path):
    """A model type comes in as its two files, with no edit to the
    harness: the loader finds them by name."""
    (tmp_path / "archs").mkdir()
    (tmp_path / "reference").mkdir()
    (tmp_path / "archs" / "toy.py").write_text(
        "\n".join(f"def {f}(*a):\n    return {f!r}" for f in HARNESS))
    (tmp_path / "reference" / "toy.py").write_text(
        "\n".join(f"def {f}(*a):\n    return {f!r}" for f in REFERENCE))
    a = arch.load({"model_type": "toy"}, bench=tmp_path)
    assert [getattr(a.harness, f)() for f in HARNESS] == list(HARNESS)
    assert [getattr(a.reference, f)() for f in REFERENCE] == list(REFERENCE)
