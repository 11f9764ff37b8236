"""The architecture of a configuration, found by its ``model_type``.

Everything that depends on a model's layer equations sits in two files
named after the configuration file's ``model_type``:

- ``bench/archs/<model_type>.py``, the harness side: ``dims(conf)`` (the
  sizes the harness, the reference and the FLOP counts read, with
  ``layer_params``, the weights a token meets in one layer),
  ``arch_config(conf)`` (the program's ``ArchConfig``, refusing what the
  program cannot compute), ``draw_model(m, seed, device)`` (every weight
  in the program's layout), ``published_layer(m, seed, i, device)`` and
  ``published_head(m, seed, device)`` (the source's weights in float32:
  a layer's leaves, and a dict with the table ``embed``, the final norm
  ``final_norm`` and, where untied, the output matrix);
- ``bench/reference/<model_type>.py``, the plain forward:
  ``layer(x, w, m, mm, segments)`` and ``logits(rows, head, m, mm)``,
  which ``reference.model.replay`` drives.

Both are loaded by path, as the metric readers are, so a new
architecture comes in as new files."""
from __future__ import annotations

from pathlib import Path
from typing import NamedTuple

from harness import spec


class Arch(NamedTuple):
    harness: object
    reference: object


def load(conf: dict, bench: Path = spec.BENCH) -> Arch:
    """The two modules of ``conf["model_type"]`` (a configuration file,
    or the ``dims`` made from one)."""
    model_type = conf["model_type"]
    paths = (bench / "archs" / f"{model_type}.py",
             bench / "reference" / f"{model_type}.py")
    missing = [p for p in paths if not p.is_file()]
    if missing:
        raise ValueError(
            f"no architecture {model_type!r} in the benchmark: add "
            + " and ".join(p.relative_to(bench.parent).as_posix()
                           for p in missing)
            + " (the harness side and the plain forward; see "
            "bench/harness/arch.py)")
    return Arch(spec.module(paths[0], "bench_arch"),
                spec.module(paths[1], "bench_reference"))
