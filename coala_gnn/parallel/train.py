"""Jitted train/eval steps.

Equivalent of the reference's training inner loop (reference:
examples/sbatch_ssd_gnn_train.py:126-151 — forward, CrossEntropyLoss,
Adam step under DDP), as one jitted function per step; data parallelism
shards the batch over the mesh ``data`` axis and psums the gradients inside
a shard_map (replacing DDP, SURVEY.md §2.4).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Sequence, Tuple

import jax
import jax.numpy as jnp
import optax

from coala_gnn.models.layers import DeviceBlock


@dataclasses.dataclass
class TrainState:
    params: Any
    opt_state: Any
    step: int = 0


def init_state(model, tx: optax.GradientTransformation,
               sample_blocks: Sequence[DeviceBlock], sample_x: jax.Array,
               seed: int = 0) -> TrainState:
    params = model.init(jax.random.key(seed), list(sample_blocks), sample_x)
    return TrainState(params=params, opt_state=tx.init(params))


def make_train_step(model, tx: optax.GradientTransformation,
                    batch_size: int) -> Callable:
    """Returns jitted step(params, opt_state, key, blocks, x, labels).

    Loss is cross-entropy over the first ``batch_size`` output rows (the
    seeds; blocks pad dst rows beyond the true batch — those rows carry no
    gradient because the output slice is static)."""

    def loss_fn(params, key, blocks, x, labels):
        logits = model.apply(params, blocks, x, train=True,
                             rngs={"dropout": key})
        logits = logits[:batch_size]
        ce = optax.softmax_cross_entropy_with_integer_labels(logits, labels)
        return ce.mean(), logits

    @jax.jit
    def step(params, opt_state, key, blocks, x, labels
             ) -> Tuple[Any, Any, jax.Array, jax.Array]:
        (loss, logits), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            params, key, blocks, x, labels)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        acc = (logits.argmax(-1) == labels).mean()
        return params, opt_state, loss, acc

    return step


def make_packed_train_step(model,
                           tx: optax.GradientTransformation,
                           batch_size: int, layout) -> Callable:
    """Train step consuming one packed int32 buffer (see data/packing.py):
    blocks + labels unpack inside the jit, so each step costs a single
    host->device transfer."""
    from coala_gnn.data.packing import unpack_batch

    def loss_fn(params, key, blocks, x, labels):
        logits = model.apply(params, blocks, x, train=True,
                             rngs={"dropout": key})
        logits = logits[:batch_size]
        ce = optax.softmax_cross_entropy_with_integer_labels(logits, labels)
        return ce.mean(), logits

    @jax.jit
    def step(params, opt_state, key, packed, x):
        blocks, labels = unpack_batch(packed, layout, batch_size)
        (loss, logits), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            params, key, blocks, x, labels)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        acc = (logits.argmax(-1) == labels).mean()
        return params, opt_state, loss, acc

    return step


def make_request_train_step(model,
                            tx: optax.GradientTransformation,
                            batch_size: int, layout, n_req: int) -> Callable:
    """Train step consuming the SAME request buffer the cache probe used
    (data/packing.pack_request): one host->device transfer serves ids,
    blocks and labels for a whole step."""
    from coala_gnn.data.packing import unpack_request_batch

    def loss_fn(params, key, blocks, x, labels):
        logits = model.apply(params, blocks, x, train=True,
                             rngs={"dropout": key})
        logits = logits[:batch_size]
        ce = optax.softmax_cross_entropy_with_integer_labels(logits, labels)
        return ce.mean(), logits

    @jax.jit
    def step(params, opt_state, key, buf, x):
        if buf.ndim == 2:   # [1, L] single-device request grid
            buf = buf[0]
        blocks, labels = unpack_request_batch(buf, n_req, layout, batch_size)
        (loss, logits), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            params, key, blocks, x, labels)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        acc = (logits.argmax(-1) == labels).mean()
        return params, opt_state, loss, acc

    return step


def make_contig_train_step(model,
                           tx: optax.GradientTransformation,
                           batch_size: int, layout, n_req: int,
                           sentinel: int) -> Callable:
    """Train step for the contiguous slot-major wire format
    (data/packing.pack_request_contig): the request buffer carries ONLY
    [n_valid | ids | labels] — adjacency is implicit in the layout and
    masks reconstruct on device from ``ids != sentinel``. Halves the
    per-step bytes of the link-bound host pipeline vs
    make_request_train_step."""
    from coala_gnn.data.packing import unpack_request_contig

    def loss_fn(params, key, blocks, x, labels):
        logits = model.apply(params, blocks, x, train=True,
                             rngs={"dropout": key})
        logits = logits[:batch_size]
        ce = optax.softmax_cross_entropy_with_integer_labels(logits, labels)
        return ce.mean(), logits

    @jax.jit
    def step(params, opt_state, key, buf, x):
        if buf.ndim == 2:   # [1, L] single-device request grid
            buf = buf[0]
        blocks, labels = unpack_request_contig(buf, n_req, layout,
                                               batch_size, sentinel)
        (loss, logits), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            params, key, blocks, x, labels)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        acc = (logits.argmax(-1) == labels).mean()
        return params, opt_state, loss, acc

    return step


def make_sharded_train_step(model,
                            tx: optax.GradientTransformation,
                            mesh, batch_size: int,
                            masked: bool = False) -> Callable:
    """Data-parallel train step over the mesh ``data`` axis.

    Replaces the reference's DDP + NCCL gradient all-reduce
    (sbatch_ssd_gnn_train.py:112, Shared_Tensor.py:63) with a shard_map whose
    gradients are pmean'd over the mesh — the collective is inserted where
    we say, not by a wrapper module.

    Inputs carry a leading device axis: blocks leaves [n_dev, ...],
    x [n_dev, cap_src, dim], labels [n_dev, B]. Params/opt_state replicated.

    ``masked=True`` returns a step taking one extra ``valid`` argument
    (bool [n_dev, B], from ``SeedDistributor.distribute(return_valid=True)``)
    and optimizes the GLOBAL masked mean — sum of per-slot CE over every
    real seed divided by the global real count, gradients psum'd. Wrapped
    tail duplicates (drop_tail=False) then contribute exactly zero gradient:
    an epoch's update sequence equals training on the real seeds alone.
    With an all-true mask this is the same global mean the unmasked step
    computes (equal per-device counts make pmean-of-means the global mean).
    """
    import jax
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from coala_gnn.parallel.mesh import DATA_AXIS

    def local_grads(params, key, blocks, x, labels, valid=None):
        blocks = jax.tree.map(lambda a: a[0], blocks)
        x, labels = x[0], labels[0]
        key = jax.random.fold_in(key, jax.lax.axis_index(DATA_AXIS))
        if masked:
            w = valid[0].astype(jnp.float32)
            n_glob = jnp.maximum(jax.lax.psum(w.sum(), DATA_AXIS), 1.0)

        def loss_fn(p):
            logits = model.apply(p, blocks, x, train=True,
                                 rngs={"dropout": key})[:batch_size]
            ce = optax.softmax_cross_entropy_with_integer_labels(logits, labels)
            if masked:
                return (ce * w).sum() / n_glob, logits
            return ce.mean(), logits

        (loss, logits), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        ok = logits.argmax(-1) == labels
        if masked:
            grads = jax.lax.psum(grads, DATA_AXIS)
            loss = jax.lax.psum(loss, DATA_AXIS)
            acc = jax.lax.psum((ok * w).sum(), DATA_AXIS) / n_glob
        else:
            grads = jax.lax.pmean(grads, DATA_AXIS)
            loss = jax.lax.pmean(loss, DATA_AXIS)
            acc = jax.lax.pmean(ok.mean(), DATA_AXIS)
        return grads, loss, acc

    def sharded(params, key, blocks, x, labels, *valid):
        grads_spec = jax.tree.map(lambda _: P(), params)
        blocks_spec = jax.tree.map(lambda _: P(DATA_AXIS), blocks)
        vspec = (P(DATA_AXIS),) if masked else ()
        return shard_map(
            local_grads, mesh=mesh,
            in_specs=(grads_spec, P(), blocks_spec, P(DATA_AXIS),
                      P(DATA_AXIS)) + vspec,
            out_specs=(grads_spec, P(), P()),
            check_vma=False)(params, key, blocks, x, labels, *valid)

    @jax.jit
    def step(params, opt_state, key, blocks, x, labels, *valid):
        grads, loss, acc = sharded(params, key, blocks, x, labels, *valid)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss, acc

    return step


def make_sharded_eval_step(model, mesh, batch_size: int,
                           per_slot: bool = False) -> Callable:
    """Data-parallel eval: per-device argmax-correct counts psum'd over the
    mesh (replaces the reference's per-rank accuracy + sklearn reduce,
    sbatch_ssd_gnn_train.py:178-193).

    per_slot=True returns the bool [n_dev, batch] correctness grid instead
    of the psum'd count, letting the caller mask out padded/wrapped seed
    slots — the exact-tail eval accounting (a split smaller than one
    global batch otherwise evaluates zero nodes)."""
    import jax
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from coala_gnn.parallel.mesh import DATA_AXIS

    def local_eval(params, blocks, x, labels):
        blocks = jax.tree.map(lambda a: a[0], blocks)
        x, labels = x[0], labels[0]
        logits = model.apply(params, blocks, x, train=False)[:batch_size]
        ok = logits.argmax(-1) == labels
        if per_slot:
            return ok[None]
        return jax.lax.psum(ok.sum(), DATA_AXIS)

    def sharded(params, blocks, x, labels):
        params_spec = jax.tree.map(lambda _: P(), params)
        blocks_spec = jax.tree.map(lambda _: P(DATA_AXIS), blocks)
        return shard_map(
            local_eval, mesh=mesh,
            in_specs=(params_spec, blocks_spec, P(DATA_AXIS), P(DATA_AXIS)),
            out_specs=P(DATA_AXIS, None) if per_slot else P(),
            check_vma=False)(params, blocks, x, labels)

    return jax.jit(sharded)


def make_eval_step(model, batch_size: int) -> Callable:
    @jax.jit
    def step(params, blocks, x, labels) -> Tuple[jax.Array, jax.Array]:
        logits = model.apply(params, blocks, x, train=False)[:batch_size]
        correct = (logits.argmax(-1) == labels).sum()
        return correct, jnp.asarray(labels.shape[0])

    return step
