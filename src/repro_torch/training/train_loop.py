"""Fault-tolerant training loop.

Composes: model forward/loss → grad → (optional) gradient compression
with error feedback → AdamW → periodic async checkpoints → restart
recovery (resume from the latest committed step, re-deriving data
batches from the counter-based pipeline).

Counterpart of ``repro/training/train_loop.py``.  The reference jits a
functional step over a params pytree; here the model's own parameters
(``models.param_tree``, the reference's leaves) are the params: the
step takes the gradients with ``torch.autograd.grad`` and writes the
new values into them.  Failure handling:

  - ``crash_after_step``-style interruption: a new TrainLoop on the same
    checkpoint dir resumes from the last commit (checkpoints in the
    reference's format: either package resumes the other's);
  - NaN-step rejection: a non-finite loss or grad norm skips the update
    — params and the whole optimizer state stay as they were, bit for
    bit, its step counter included, so the lr schedule and the bias
    correction do not advance, while the loop's step still counts — and
    ``skipped`` is 1 in the metrics.  The error-feedback state is not
    rolled back, as in the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from repro_torch.checkpointing import AsyncCheckpointer, latest_step, \
    restore
from repro_torch.data.pipeline import SyntheticLMData
from repro_torch.models import LOCAL, Model, Runtime, param_tree
from repro_torch.training.grad_compress import (
    CompressorConfig,
    compress_grads,
    init_error_state,
)
from repro_torch.training.loss import lm_loss
from repro_torch.training.optimizer import (
    AdamWState,
    OptimizerConfig,
    adamw_init,
    adamw_update,
)
from repro_torch.tree import tensors, unflatten_tensors


@dataclasses.dataclass
class TrainConfig:
    steps: int = 100
    checkpoint_every: int = 25
    checkpoint_dir: Optional[str] = None
    optimizer: OptimizerConfig = dataclasses.field(
        default_factory=OptimizerConfig)
    compressor: CompressorConfig = dataclasses.field(
        default_factory=CompressorConfig)
    log_every: int = 10


@dataclasses.dataclass(frozen=True)
class _StepHooks:
    """What a mesh changes in the train step; the defaults are the one
    device's.  ``prepare(params)`` → (the module the forward runs on,
    the tree of stored tensors AdamW updates); ``loss(logits, targets,
    mask)``; ``reduce_grads(params, grads)`` → the gradients of the
    stored tensors; ``grad_norm(params, grads)`` → their global norm
    (None: AdamW's own); ``reduce_max`` → the int8 compressor's max of a
    leaf over the ranks holding its blocks (None: one device)."""
    prepare: Callable = lambda params: (params, param_tree(params))
    loss: Callable = lm_loss
    reduce_grads: Callable = lambda params, grads: grads
    grad_norm: Callable = lambda params, grads: None
    reduce_max: Optional[Callable] = None


def make_train_step(model: Model, tcfg: TrainConfig,
                    rt: Runtime = LOCAL) -> Callable:
    """Builds the (params, opt, err, batch) → (params, opt, err,
    metrics) step; ``params`` is the model's module, updated in place
    (and returned).  With a mesh-ful ``rt`` it is the sharded step:
    ``params`` a ``distributed.sharding.ShardedParams`` whose shards are
    updated in place, ``opt`` and ``err`` made over its shards, and the
    batch this rank's rows (see :func:`_mesh_hooks`)."""
    hooks = _mesh_hooks(model, rt) if rt.sharded else _StepHooks()

    def step_fn(params, opt_state: AdamWState, err_state, batch):
        module, stored = hooks.prepare(params)
        tree = param_tree(module)
        flat = tensors(tree)
        for t in flat:
            t.requires_grad_(True)
        logits = model.forward_train(module, batch["tokens"],
                                     extra_embed=batch.get("extra_embed"),
                                     remat=rt.remat, rt=rt)
        tgt = batch["targets"]
        logits = logits[:, -tgt.shape[1]:, :]
        loss, metrics = hooks.loss(logits, tgt, batch.get("mask"))
        grads = torch.autograd.grad(loss, flat, allow_unused=True,
                                    materialize_grads=True)
        del logits
        for t in flat:
            t.requires_grad_(False)
        grads = hooks.reduce_grads(
            params, unflatten_tensors(tree, list(grads)))
        metrics = {k: v.detach() for k, v in metrics.items()}

        # gradient compression round-trip (cross-pod wire format)
        grads, err_state = compress_grads(grads, err_state, tcfg.compressor,
                                          reduce_max=hooks.reduce_max)

        with torch.no_grad():
            new_tree, new_opt, opt_metrics = adamw_update(
                stored, grads, opt_state, tcfg.optimizer,
                grad_norm=hooks.grad_norm(params, grads))
            # NaN-step rejection: keep the old state when loss/grads blew
            # up (one read of a flag back to the host)
            ok = bool(torch.isfinite(metrics["loss"])
                      & torch.isfinite(opt_metrics["grad_norm"]))
            if ok:
                for t, new in zip(tensors(stored), tensors(new_tree)):
                    t.copy_(new)
                opt_state = new_opt
        metrics = {**metrics, **opt_metrics,
                   "skipped": torch.tensor(0.0 if ok else 1.0)}
        return params, opt_state, err_state, metrics

    return step_fn


def _mesh_hooks(model: Model, rt: Runtime) -> _StepHooks:
    """The reference's jitted train step under a mesh, written out: the
    FSDP dims gathered into the compute view, the forward and a
    vocab-parallel loss on the rank's rows, the gradients reduced to the
    stored blocks (:func:`~repro_torch.distributed.sharding.reduce_grads`),
    int8 compression with each leaf's max over the mesh, and AdamW on
    the blocks with the global norm counting each element once."""
    from repro_torch.distributed.collectives import all_max
    from repro_torch.distributed.sharding import gather_params, grad_norm, \
        reduce_grads
    from repro_torch.training.loss import lm_loss_sharded

    n = model.cfg.padded_vocab // rt.tp_size

    def prepare(params):
        rows = params.module.embed.shape[0]
        if rows * rt.tp_size != model.cfg.padded_vocab:
            raise ValueError(f"{model.cfg.name}: the vocab-parallel loss "
                             f"needs the table split over tp ({rows} rows)")
        gather_params(params)
        return params.module, params.shards

    mesh = rt.mesh
    return _StepHooks(
        prepare=prepare,
        loss=lambda logits, tgt, mask: lm_loss_sharded(
            logits, tgt, mask, rt, rt.tp_index * n),
        reduce_grads=reduce_grads,
        grad_norm=grad_norm,
        reduce_max=lambda m: all_max(m, mesh, mesh.axis_names))


class TrainLoop:
    """``params`` (the model's module) is trained in place; without it
    the model is initialised from ``gen`` (default: a generator on
    ``device`` seeded with 0 — the reference starts from its own fixed
    ``PRNGKey(0)``)."""

    def __init__(self, model: Model, data: SyntheticLMData,
                 tcfg: TrainConfig, rt: Runtime = LOCAL,
                 params: Optional[torch.nn.Module] = None,
                 gen: Optional[torch.Generator] = None,
                 device="cuda") -> None:
        if model.cfg.is_encoder_decoder:
            raise ValueError(
                f"{model.cfg.name}: an encoder-decoder model trains on "
                "frames, and the synthetic data pipeline gives none (fault "
                "C11: the reference's TrainLoop fails the same way)")
        if rt.sharded:
            raise NotImplementedError(
                "TrainLoop runs on one device; a mesh-ful runtime trains "
                "through make_train_step with ShardedParams")
        self.model = model
        self.data = data
        self.tcfg = tcfg
        self.rt = rt
        self.step_fn = make_train_step(model, tcfg, rt)
        if params is None:
            gen = gen or torch.Generator(device=device).manual_seed(0)
            params = model.init(gen, device)
        self.params = params
        self.device = params.device
        tree = param_tree(params)
        self.opt_state = adamw_init(tree)
        self.err_state = (init_error_state(tree)
                          if tcfg.compressor.kind != "none" else None)
        self.start_step = 0
        self.ckpt = (AsyncCheckpointer(tcfg.checkpoint_dir)
                     if tcfg.checkpoint_dir else None)
        self.history: list[dict] = []
        self._maybe_resume()

    def state(self) -> dict[str, Any]:
        """What a checkpoint holds: the reference's ``{"params", "opt"}``."""
        return {"params": param_tree(self.params), "opt": self.opt_state}

    # -- fault tolerance -----------------------------------------------------
    def _maybe_resume(self) -> None:
        if not self.tcfg.checkpoint_dir:
            return
        step = latest_step(self.tcfg.checkpoint_dir)
        if step is None:
            return
        state = self.state()
        restored = restore(self.tcfg.checkpoint_dir, step, state)
        with torch.no_grad():
            for t, new in zip(tensors(state["params"]),
                              tensors(restored["params"])):
                t.copy_(new)
        self.opt_state = restored["opt"]
        self.start_step = step
        self.history.append({"resumed_from": step})

    def _checkpoint(self, step: int) -> None:
        if self.ckpt is None:
            return
        self.ckpt.save(step, self.state())

    # -- main loop ------------------------------------------------------------
    def run(self, steps: Optional[int] = None,
            crash_after_step: Optional[int] = None) -> list[dict]:
        """Run (resuming from the last commit).  ``crash_after_step``
        raises after that step — the fault-injection hook for tests."""
        total = steps if steps is not None else self.tcfg.steps
        logs = []
        for step in range(self.start_step, total):
            batch = {k: torch.as_tensor(v, device=self.device) for k, v in
                     self.data.global_batch_at(step).items()}
            self.params, self.opt_state, self.err_state, metrics = \
                self.step_fn(self.params, self.opt_state,
                             self.err_state, batch)
            if (step % self.tcfg.log_every == 0 or step == total - 1):
                entry = {"step": step,
                         "loss": float(metrics["loss"]),
                         "accuracy": float(metrics["accuracy"]),
                         "grad_norm": float(metrics["grad_norm"]),
                         "lr": float(metrics["lr"]),
                         "skipped": float(metrics["skipped"])}
                logs.append(entry)
                self.history.append(entry)
            if ((step + 1) % self.tcfg.checkpoint_every == 0
                    or step == total - 1):
                self._checkpoint(step + 1)
            if crash_after_step is not None and step >= crash_after_step:
                if self.ckpt:
                    self.ckpt.wait()
                raise RuntimeError(f"injected crash after step {step}")
        if self.ckpt:
            self.ckpt.wait()
        self.start_step = total
        return logs
