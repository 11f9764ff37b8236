"""The JAX package's sharded programs on an Auto-axis mesh of host
devices, as the port's model-sharding tests hold the port to them.

    XLA_FLAGS=--xla_force_host_platform_device_count=8 \\
        python tests/torch_shard_reference.py JOBS.pkl OUT.pkl

JOBS.pkl maps a key to ``(kind, args)``; OUT.pkl maps it to the
result.  The mesh is ``jax.make_mesh(..., axis_types=(Auto,) * n)``:
JAX 0.9 makes Explicit axes by default, and the reference's
``with_sharding_constraint`` (``repro/models/runtime.py``) refuses
those (fault C4).  On Auto axes the reference's own ``make_plan`` /
``param_pspecs`` / ``cache_pspecs`` place the arrays and GSPMD inserts
the collectives.  Not a test module: the tests run it in a subprocess
(the test process keeps one host device).
"""
import pickle
import sys

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import AxisType, NamedSharding
from jax.sharding import PartitionSpec as P

from repro.checkpointing import restore, save
from repro.configs import get_config
from repro.distributed.sharding import cache_pspecs, make_plan, param_pspecs
from repro.models import build_model
from repro.models import moe as moe_lib
from repro.training.loss import lm_loss
from repro.training.optimizer import OptimizerConfig, adamw_init, \
    adamw_update

try:                                 # jax ≥ 0.6 exports it at top level
    shard_map = jax.shard_map
except AttributeError:
    from jax.experimental.shard_map import shard_map


def auto_mesh(shape, axes=("data", "model")):
    n = int(np.prod(shape))
    return jax.make_mesh(shape, axes, axis_types=(AxisType.Auto,) * len(axes),
                         devices=jax.devices()[:n])


def reduced(arch, **over):
    """The reduced config of tests/test_distributed.py."""
    base = get_config(arch)
    return base.reduced(d_model=128, num_heads=4, num_kv_heads=2,
                        head_dim=32, vocab_size=512,
                        d_ff=0 if base.d_ff == 0 else 256, **over)


def fan_in_d(p, cfg):
    """The params with every attention layer's wq and wk scaled to the
    fan-in d (the init draws them at the head count's, fault C14)."""
    def one(path, x):
        keys = [getattr(k, "key", None) for k in path]
        if keys[-1] in ("wq", "wk") and keys[-2] in ("attn", "self_attn",
                                                     "cross_attn"):
            return x * np.sqrt(x.shape[-2] / cfg.d_model).astype(x.dtype)
        return x
    return jax.tree_util.tree_map_with_path(one, p)


def init(model, cfg, fan_d):
    p = model.init(jax.random.PRNGKey(0))
    return fan_in_d(p, cfg) if fan_d else p


def put(tree, specs, mesh):
    return jax.tree.map(
        lambda x, s: jax.device_put(x, NamedSharding(mesh, s)), tree, specs,
        is_leaf=lambda x: isinstance(x, P))


def rows(mesh, B, nd):
    return NamedSharding(mesh, P("data" if B % nd == 0 else None))


def params(arch, over, fan_d=False):
    cfg = reduced(arch, **over)
    return jax.tree.map(np.asarray, init(build_model(cfg), cfg, fan_d))


def serve(arch, over, mesh_shape, tokens, fed, extra, max_seq, fan_d=False):
    """Prefill logits, then one logits column a decode step fed ``fed``
    (``extra``: a VLM's patch embeddings before the prompt, or an
    encoder-decoder's frames)."""
    cfg = reduced(arch, **over)
    model = build_model(cfg)
    mesh = auto_mesh(mesh_shape)
    plan = make_plan(cfg, mesh, "serve")
    rt = plan.runtime(kv_cache_dtype="float32")
    p = init(model, cfg, fan_d)
    cache = model.init_cache(tokens.shape[0], max_seq, rt)
    p = put(p, param_pspecs(plan, p), mesh)
    cache = put(cache, cache_pspecs(plan, cache), mesh)
    sh = rows(mesh, tokens.shape[0], mesh_shape[0])
    ex = None if extra is None else jax.device_put(jnp.asarray(extra), sh)
    prefill = jax.jit(lambda p, c, t, e: model.prefill(p, t, c, rt,
                                                       extra_embed=e))
    decode = jax.jit(lambda p, c, t, i: model.decode_step(p, t, c, i, rt))
    logits, cache = prefill(p, cache, jax.device_put(jnp.asarray(tokens), sh),
                            ex)
    out = [np.asarray(logits, np.float32)]
    n0 = tokens.shape[1] + (0 if extra is None or cfg.is_encoder_decoder
                            else extra.shape[1])
    for t in range(fed.shape[1]):
        logits, cache = decode(p, cache,
                               jax.device_put(jnp.asarray(fed[:, t:t + 1]),
                                              sh), jnp.int32(n0 + t))
        out.append(np.asarray(logits, np.float32))
    return out


def train(arch, over, mesh_shape, tokens, targets, extra, fan_d=False):
    """One sharded train step (tests/test_distributed.py's): the loss,
    the new params' leaves and the new first moments' leaves."""
    cfg = reduced(arch, **over)
    model = build_model(cfg)
    mesh = auto_mesh(mesh_shape)
    plan = make_plan(cfg, mesh, "train")
    rt = plan.runtime()
    ocfg = OptimizerConfig()

    def step(p, o, tok, tgt, e):
        def loss_fn(pp):
            logits = model.forward_train(pp, tok, rt=rt, extra_embed=e)
            return lm_loss(logits[:, -tgt.shape[1]:, :], tgt)[0]
        loss, grads = jax.value_and_grad(loss_fn)(p)
        new, state, _ = adamw_update(p, grads, o, ocfg)
        return loss, new, state.mu

    p = init(model, cfg, fan_d)
    p = put(p, param_pspecs(plan, p), mesh)
    sh = rows(mesh, tokens.shape[0], mesh_shape[0])
    e = None if extra is None else jax.device_put(jnp.asarray(extra), sh)
    loss, new, mu = jax.jit(step)(p, adamw_init(p),
                                  jax.device_put(jnp.asarray(tokens), sh),
                                  jax.device_put(jnp.asarray(targets), sh), e)
    return float(loss), *([np.asarray(x, np.float32)
                           for x in jax.tree.leaves(t)] for t in (new, mu))


def moe_ep(arch, over, mesh_shape, x):
    """``moe_mlp_ep`` under ``shard_map`` (the reference's ``_apply_mlp``
    specs) on the first layer's MoE params, with each data shard's
    dispatch: (out, keep, dst), the last two one row a data shard."""
    cfg = reduced(arch, **over)
    mesh = auto_mesh(mesh_shape)
    p = build_model(cfg).init(jax.random.PRNGKey(0))
    moe = jax.tree.map(lambda a: a[0], p["periods"]["k0"]["moe"])
    specs = {"router": P(None, None), "w_gate": P("data", None, "model"),
             "w_up": P("data", None, "model"),
             "w_down": P("data", "model", None)}

    def body(mp, xs):
        out = moe_lib.moe_mlp_ep(mp, xs, cfg, ("data",), "model")
        T = xs.shape[0]
        C = max(1, int(T * cfg.experts_per_token / cfg.num_experts
                       * cfg.moe_capacity_factor))
        _, idx = moe_lib.route(mp["router"], xs, cfg)
        _, dst, keep = moe_lib._dispatch_indices(idx.reshape(-1),
                                                 cfg.num_experts, C)
        return out, keep[None], dst[None]

    fn = shard_map(body, mesh=mesh, in_specs=(specs, P("data", None)),
                   out_specs=(P("data", None), P("data", None),
                              P("data", None)))
    out, keep, dst = jax.jit(fn)(put(moe, specs, mesh), jnp.asarray(x))
    return [np.asarray(a) for a in (out, keep, dst)]


def ckpt_save(directory, step, n, leaves):
    """Save ``leaves`` ({key: (array, dtype, spec)}) sharded over n
    devices."""
    mesh = auto_mesh((n,), ("data",))
    tree = {k: jax.device_put(jnp.asarray(a, jnp.dtype(d)),
                              NamedSharding(mesh, P(*s)))
            for k, (a, d, s) in leaves.items()}
    save(directory, step, tree)
    return True


def ckpt_restore(directory, step, n, leaves):
    """Restore ``leaves`` ({key: (shape, dtype, spec)}) sharded over n
    devices: each leaf's device count and its whole value."""
    mesh = auto_mesh((n,), ("data",))
    target = {k: jax.ShapeDtypeStruct(s, jnp.dtype(d))
              for k, (s, d, _) in leaves.items()}
    shardings = {k: NamedSharding(mesh, P(*sp))
                 for k, (_, _, sp) in leaves.items()}
    out = restore(directory, step, target, shardings)
    return {k: (v.sharding.num_devices, np.asarray(v.astype(jnp.float32)))
            for k, v in out.items()}


KINDS = {"params": params, "serve": serve, "train": train, "moe_ep": moe_ep,
         "ckpt_save": ckpt_save, "ckpt_restore": ckpt_restore}

if __name__ == "__main__":
    with open(sys.argv[1], "rb") as f:
        jobs = pickle.load(f)           # written by the calling test
    out = {key: KINDS[kind](*args) for key, (kind, args) in jobs.items()}
    with open(sys.argv[2], "wb") as f:
        pickle.dump(out, f)
