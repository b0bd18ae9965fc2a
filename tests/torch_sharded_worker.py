"""The ranks of the port's sharded-training tests: gloo worlds on the CPU,
or on the one card.

``run_world(world, scenarios, out_dir, device)`` spawns ``world`` processes
that join one process group through a file under ``out_dir`` (gloo on the
CPU; on the card the transport ``pick_backend`` takes), set ``train.mesh``
to the world size and run each scenario on ``device``, as a user's ranks
would: every rank is handed the same whole input and calls the same entry
point. Rank r writes scenario ``name``'s arrays to
``out_dir/{name}_w{world}_r{r}.npz``; ``run_world`` returns them per rank.

Run as a script under torchrun (``python -m torch.distributed.run
--standalone --nproc-per-node N tests/torch_sharded_worker.py OUT``), each
rank makes no process group itself: ``train.mesh`` set to the world size
makes the port's ``ensure_distributed`` initialise it from torchrun's
environment, and the rank writes a LogisticRegression fit's coefficient to
``OUT/torchrun_r{rank}.npy``.

This module imports torch, numpy and the port only: a spawned rank imports
it and never the test module, which imports JAX.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

Scenario = Tuple[str, str, dict]  # (name, function in this module, keyword arguments)


#: A rank that waits on a collective longer than this fails, and the world
#: with it, instead of stalling the suite.
TIMEOUT_S = 120


def run_world(world: int, scenarios: Sequence[Scenario], out_dir: str,
              device: str = "cpu", mesh: Optional[Tuple[int, int]] = None,
              tag: str = "") -> Dict[str, List[dict]]:
    """Run ``scenarios`` on a world of ``world`` ranks on ``device`` with
    ``train.mesh`` × ``train.mesh.model`` = ``mesh`` (default ``(world,
    1)``); a rank's failure raises here with its traceback. ``tag`` keeps
    two worlds of one width apart in ``out_dir``."""
    from flink_ml_tpu_torch.parallel.train_sharding import pick_backend

    mesh = mesh or (world, 1)
    key = f"w{world}{tag}"
    init = f"file://{os.path.join(out_dir, f'init_{key}_{device}')}"
    mp.start_processes(_rank_main, args=(world, init, out_dir, list(scenarios), device,
                                         pick_backend(world, device), mesh, key),
                       nprocs=world, join=True, start_method="spawn")
    results = {}
    for name, _fn, _kw in scenarios:
        results[name] = []
        for r in range(world):
            with np.load(os.path.join(out_dir, f"{name}_{key}_r{r}.npz")) as z:
                results[name].append({k: z[k] for k in z.files})
    return results


def _rank_main(rank: int, world: int, init: str, out_dir: str, scenarios: List[Scenario],
               device: str, backend: str, mesh: Tuple[int, int] = None, key: str = "") -> None:
    import datetime
    import faulthandler

    faulthandler.enable()  # a rank that dies in native code still prints where

    from flink_ml_tpu_torch.config import Options, config

    torch.set_num_threads(1)
    if device != "cpu":
        torch.cuda.set_device(0)
    dist.init_process_group(backend, init_method=init, world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        n_data, n_model = mesh or (world, 1)
        config.set(Options.TRAIN_MESH, n_data)
        if n_model > 1:
            config.set(Options.TRAIN_MESH_MODEL, n_model)
        for name, fn, kwargs in scenarios:
            out = globals()[fn](device=device, **kwargs)
            np.savez(os.path.join(out_dir, f"{name}_{key or f'w{world}'}_r{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


# --- scenarios ----------------------------------------------------------------


def _loss(name):
    from flink_ml_tpu_torch.ops.lossfunc import BinaryLogisticLoss, LeastSquareLoss

    return {"logistic": BinaryLogisticLoss.INSTANCE, "least_squares": LeastSquareLoss.INSTANCE}[name]


def sgd(data: dict, dim: int, device: str, loss: str = "logistic", **kw) -> dict:
    """``SGD.optimize`` on the whole columns (``train.mesh`` routes it)."""
    from flink_ml_tpu_torch.ops.optimizer import SGD

    opt = SGD(device=device, **kw)
    coef = opt.optimize(np.zeros(dim, np.float32), data, _loss(loss))
    return {"coef": coef, "losses": np.asarray(opt.loss_history, np.float64)}


def sgd_on_mesh(data: dict, dim: int, mesh: Tuple[int, int, int], device: str,
                loss: str = "logistic", **kw) -> dict:
    """``SGD.optimize`` with an explicit ``MeshContext(n_data, n_model,
    n_slices)`` (the psum paths; JAX's ``SGD(ctx=...)``)."""
    from flink_ml_tpu_torch.ops.optimizer import SGD
    from flink_ml_tpu_torch.parallel.mesh import MeshContext

    n_data, n_model, n_slices = mesh
    ctx = MeshContext(n_data, n_model, device=device, n_slices=n_slices)
    opt = SGD(ctx=ctx, **kw)
    coef = opt.optimize(np.zeros(dim, np.float32), data, _loss(loss))
    return {"coef": coef, "losses": np.asarray(opt.loss_history, np.float64),
            "premat": np.asarray(opt.onehot_premat_active)}


def logistic_regression(features: np.ndarray, labels: np.ndarray, iters: int, batch: int, device: str) -> dict:
    """``LogisticRegression().fit(df)``: the entry point a user calls."""
    from flink_ml_tpu_torch.api.dataframe import DataFrame
    from flink_ml_tpu_torch.models.classification.logistic_regression import LogisticRegression

    df = DataFrame.from_dict({"features": features, "label": labels})
    model = (LogisticRegression().set_max_iter(iters).set_global_batch_size(batch)
             .set_learning_rate(0.1).set_tol(0.0).fit(df, device=device))
    return {"coef": np.asarray(model.coefficient)}


def groups_reused(features: np.ndarray, labels: np.ndarray, iters: int, batch: int, device: str) -> dict:
    """Two ``LogisticRegression().fit(df)`` calls in a row on the world's
    mesh: the axis subgroups each fit asks for, and the process groups
    ``dist.new_group`` made during each, counted."""
    from flink_ml_tpu_torch.parallel import mesh

    asked, made = [], []
    real_new, real_sub = dist.new_group, mesh._subgroup

    def new_group(*a, **kw):
        made[-1] += 1
        return real_new(*a, **kw)

    def subgroup(ranks):
        asked[-1] += 1
        return real_sub(ranks)

    coefs = []
    dist.new_group, mesh._subgroup = new_group, subgroup
    try:
        for _ in range(2):
            asked.append(0)
            made.append(0)
            coefs.append(logistic_regression(features, labels, iters, batch, device)["coef"])
    finally:
        dist.new_group, mesh._subgroup = real_new, real_sub
    return {"asked": np.asarray(asked), "made": np.asarray(made), "coef0": coefs[0], "coef1": coefs[1]}


def kmeans(points: np.ndarray, k: int, seed: int, iters: int, measure: str, device: str) -> dict:
    from flink_ml_tpu_torch.api.dataframe import DataFrame
    from flink_ml_tpu_torch.metrics import MLMetrics, metrics
    from flink_ml_tpu_torch.models.clustering.kmeans import KMeans

    def count(name):
        return metrics.get(MLMetrics.TRAIN_GROUP, name, 0)

    names = (MLMetrics.TRAIN_SHARDED_FITS, MLMetrics.TRAIN_SHARD_INGEST_ROWS, MLMetrics.TRAIN_SHARD_PAD_ROWS)
    before = [count(n) for n in names]
    model = (KMeans().set_k(k).set_seed(seed).set_max_iter(iters).set_distance_measure(measure)
             .fit(DataFrame.from_dict({"features": points}), device=device))
    fits, ingest, pad = (count(n) - b for n, b in zip(names, before))
    return {"centroids": model.centroids, "weights": model.weights, "fits": np.asarray(fits),
            "ingest_rows": np.asarray(ingest), "pad_rows": np.asarray(pad)}


def mlp(features: np.ndarray, labels: np.ndarray, hidden: int, iters: int, batch: int, seed: int,
        device: str) -> dict:
    from flink_ml_tpu_torch.api.dataframe import DataFrame
    from flink_ml_tpu_torch.models.classification.mlp_classifier import MLPClassifier

    est = (MLPClassifier().set_hidden_layers(hidden).set_max_iter(iters).set_global_batch_size(batch)
           .set_seed(seed).set_tol(0.0))
    model = est.fit(DataFrame.from_dict({"features": features, "label": labels}), device=device)
    out = {"losses": np.asarray(est.loss_history, np.float64)}
    for i, (W, b) in enumerate(model.params):
        out[f"W{i}"], out[f"b{i}"] = W, b
    return out


def ring(q: np.ndarray, k: np.ndarray, v: np.ndarray, g: np.ndarray, causal: bool, n_valid, device: str) -> dict:
    """``ring_attention_sharded`` of the whole [B, T, H, D] inputs on the
    world's data axis, and the VJP of this rank's slice of the output with
    the cotangent ``g``'s slice: the rank's dq, dk and dv."""
    from flink_ml_tpu_torch.parallel.mesh import MeshContext
    from flink_ml_tpu_torch.parallel.ring import ring_attention, ring_attention_sharded

    ctx = MeshContext(device=device)
    out = ring_attention_sharded(q, k, v, causal=causal, ctx=ctx, n_valid=n_valid)
    t = q.shape[1] // ctx.n_data
    sl = slice(ctx.rank * t, (ctx.rank + 1) * t)
    leaves = [torch.from_numpy(np.ascontiguousarray(x[:, sl])).to(ctx.device).requires_grad_(True)
              for x in (q, k, v)]
    got = ring_attention(*leaves, causal=causal, n_valid=n_valid, ctx=ctx)
    dq, dk, dv = torch.autograd.grad(got, leaves, torch.from_numpy(np.ascontiguousarray(g[:, sl])).to(ctx.device))
    return {"out": out.detach().cpu().numpy(), "out_grad_path": got.detach().cpu().numpy(),
            "dq": dq.cpu().numpy(), "dk": dk.cpu().numpy(), "dv": dv.cpu().numpy()}


def attention_classifier(tokens: np.ndarray, labels: np.ndarray, params: dict, held: np.ndarray,
                         device: str) -> dict:
    """``SelfAttentionClassifier.fit`` and the fitted model's ``transform``
    of ``held`` with the sequence split over the world."""
    from flink_ml_tpu_torch.api.dataframe import DataFrame
    from flink_ml_tpu_torch.models.classification.attention_classifier import SelfAttentionClassifier

    est = SelfAttentionClassifier()
    for name, value in params.items():
        getattr(est, f"set_{name}")(value)
    df = DataFrame.from_dict({"features": tokens, "label": labels})
    model = est.fit(df, device=device)
    out = model.transform(DataFrame.from_dict({"features": held}), device=device)
    res = {"losses": np.asarray(est.loss_history, np.float64),
           "probs": np.asarray(out.vectors(model.get_raw_prediction_col())),
           "pred": np.asarray(out.scalars(model.get_prediction_col()))}
    res.update({f"p_{k}": v for k, v in model.params.items()})
    return res


def ring_uneven(device: str) -> dict:
    """``ring_attention_sharded`` of a sequence the world does not divide:
    the error it raises."""
    from flink_ml_tpu_torch.parallel.mesh import MeshContext
    from flink_ml_tpu_torch.parallel.ring import ring_attention_sharded

    ctx = MeshContext(device=device)
    x = np.zeros((1, 2 * ctx.n_data + 1, 1, 8), np.float32)
    try:
        ring_attention_sharded(x, x, x, ctx=ctx)
    except ValueError as e:
        return {"error": np.asarray(str(e))}
    return {"error": np.asarray("")}


def moe(x: np.ndarray, router: np.ndarray, w1: np.ndarray, w2: np.ndarray, g: np.ndarray, capacity: int,
        device: str) -> dict:
    """``moe_ffn_sharded`` of the whole inputs on the world's data axis; the
    rank's experts (``route_top1``) and the tokens the call kept (its
    nonzero rows: a dropped token's row is exactly 0); and the VJP of its
    output slice with ``g``'s slice in its tokens, the router and its
    experts."""
    from flink_ml_tpu_torch.parallel.mesh import MeshContext
    from flink_ml_tpu_torch.parallel.moe import moe_ffn, moe_ffn_sharded, route_top1

    ctx = MeshContext(device=device)
    n, i = ctx.n_data, ctx.rank
    out = moe_ffn_sharded(x, router, w1, w2, capacity, ctx=ctx)
    t, e = x.shape[0] // n, w1.shape[0] // n
    dev = ctx.device

    def leaf(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev).requires_grad_(True)

    leaves = [leaf(x[i * t:(i + 1) * t]), leaf(router), leaf(w1[i * e:(i + 1) * e]), leaf(w2[i * e:(i + 1) * e])]
    got = moe_ffn(*leaves, capacity, ctx)
    grads = torch.autograd.grad(got, leaves, torch.from_numpy(np.ascontiguousarray(g[i * t:(i + 1) * t])).to(dev))
    expert = route_top1(leaves[0].detach(), leaves[1].detach(), capacity)[0]
    out = out.detach().cpu().numpy()
    return {"out": out, "expert": expert.cpu().numpy(), "keep": np.any(out != 0, axis=1),
            **{f"d{k}": gr.cpu().numpy() for k, gr in zip(("x", "router", "w1", "w2"), grads)}}


def moe_uneven(device: str) -> dict:
    """``moe_ffn_sharded`` of token and expert counts the world does not
    divide: the errors it raises."""
    from flink_ml_tpu_torch.parallel.mesh import MeshContext
    from flink_ml_tpu_torch.parallel.moe import moe_ffn_sharded

    ctx = MeshContext(device=device)
    n, d = ctx.n_data, 4
    errors = []
    for t, e in ((2 * n + 1, n), (2 * n, n + 1)):
        x, router = np.zeros((t, d), np.float32), np.zeros((d, e), np.float32)
        w1, w2 = np.zeros((e, d, d), np.float32), np.zeros((e, d, d), np.float32)
        try:
            moe_ffn_sharded(x, router, w1, w2, 4, ctx=ctx)
            errors.append("")
        except ValueError as err:
            errors.append(str(err))
    return {"errors": np.asarray(errors)}


def rank_rows(rank: int) -> np.ndarray:
    """Rank ``rank``'s own [rank + 3, 4] rows for the collectives scenario."""
    return np.random.default_rng(100 + rank).normal(size=(rank + 3, 4)).astype(np.float32)


def collectives(device: str) -> dict:
    """``all_reduce_sum`` / ``all_reduce_mean`` of each rank's own rows,
    ``psum_tree`` of a tree of rank-valued tensors, ``place_state``."""
    from flink_ml_tpu_torch.parallel import all_reduce_mean, all_reduce_sum, psum_tree
    from flink_ml_tpu_torch.parallel.train_sharding import resolve_train_sharding

    ts = resolve_train_sharding(device)
    ctx = ts.ctx
    rows = rank_rows(ctx.rank)
    r = torch.tensor(float(ctx.rank + 1), device=ctx.device)
    tree = psum_tree({"a": [r, r * 2], "b": (r * torch.ones(3, device=ctx.device),)}, ctx)
    placed = ts.place_state([np.arange(3.0), (np.ones(2),)])
    return {"sum": all_reduce_sum(rows, ctx).cpu().numpy(), "mean": all_reduce_mean(rows, ctx).cpu().numpy(),
            "a0": tree["a"][0].cpu().numpy(), "a1": tree["a"][1].cpu().numpy(), "b": tree["b"][0].cpu().numpy(),
            "placed_on": np.asarray([str(placed[0].device), str(placed[1][0].device)]),
            "placed": placed[0].cpu().numpy()}


class _FailAt:
    """A listener that raises at one epoch."""

    def __init__(self, epoch):
        self.epoch = epoch

    def on_epoch_watermark_incremented(self, epoch, context):
        if epoch == self.epoch:
            raise RuntimeError(f"injected failure at epoch {epoch}")

    def on_iteration_terminated(self, context):
        pass


def sgd_killed_and_resumed(data: dict, dim: int, ckpt_dir: str, fail_at: int, device: str, **kw) -> dict:
    """The host loop on the mesh with a ``ShardedCheckpointManager``: a
    clean fit, then a fit whose listener raises at ``fail_at`` and its
    resumption from the manager's snapshots."""
    from flink_ml_tpu_torch.checkpoint import ShardedCheckpointManager
    from flink_ml_tpu_torch.ops.optimizer import SGD
    from flink_ml_tpu_torch.parallel.train_sharding import resolve_train_sharding

    ts = resolve_train_sharding(device)
    loss = _loss("least_squares")
    clean_mgr = ShardedCheckpointManager(os.path.join(ckpt_dir, "clean"), sharding=ts)
    clean = SGD(device=device, checkpoint_manager=clean_mgr, checkpoint_interval=5, **kw)
    coef_clean = clean.optimize(np.zeros(dim, np.float32), data, loss)
    mgr = ShardedCheckpointManager(os.path.join(ckpt_dir, "killed"), sharding=ts)
    try:
        SGD(device=device, checkpoint_manager=mgr, checkpoint_interval=5, listeners=[_FailAt(fail_at)],
            **kw).optimize(np.zeros(dim, np.float32), data, loss)
        raise AssertionError("the listener did not stop the fit")
    except RuntimeError as e:
        if "injected failure" not in str(e):
            raise
    steps = np.asarray(mgr.all_steps())
    resumed = SGD(device=device, checkpoint_manager=mgr, checkpoint_interval=5, **kw)
    coef = resumed.optimize(np.zeros(dim, np.float32), data, loss)
    return {"clean": coef_clean, "resumed": coef, "steps": steps,
            "clean_losses": np.asarray(clean.loss_history), "resumed_losses": np.asarray(resumed.loss_history)}


def restore_snapshot(ckpt_dir: str, device: str) -> dict:
    """The newest snapshot under ``ckpt_dir`` restored on this world's mesh
    (its leaves are replicated, so any width takes it)."""
    from flink_ml_tpu_torch.checkpoint import ShardedCheckpointManager
    from flink_ml_tpu_torch.parallel.train_sharding import resolve_train_sharding

    step, state = ShardedCheckpointManager(ckpt_dir, sharding=resolve_train_sharding(device)).restore_latest()
    return {"step": np.asarray(step), "coef": np.asarray(state[0]), "offset": np.asarray(state[1])}


# --- streamed fits (a host-tier cache on every rank) ------------------------------


def host_cache(columns: dict, chunk: int = 40):
    """A ``HostDataCache`` of ``columns`` in ``chunk``-row chunks (every rank
    builds the same one, as every rank is handed the whole input)."""
    from flink_ml_tpu_torch.iteration.datacache import HostDataCache

    cache = HostDataCache()
    n = len(next(iter(columns.values())))
    for a in range(0, n, chunk):
        cache.append({k: v[a:a + chunk] for k, v in columns.items()})
    cache.finish()
    return cache


def _streamed_sgd(ctx_mesh, device, **kw):
    from flink_ml_tpu_torch.ops.optimizer import SGD
    from flink_ml_tpu_torch.parallel.mesh import MeshContext

    if ctx_mesh is None:  # train.mesh routes the fit
        return SGD(device=device, **kw)
    n_data, n_model, n_slices = ctx_mesh
    return SGD(ctx=MeshContext(n_data, n_model, device=device, n_slices=n_slices), **kw)


def sgd_streamed(data: dict, dim: int, device: str, mesh: Optional[Tuple[int, int, int]] = None,
                 loss: str = "logistic", **kw) -> dict:
    """``SGD.optimize`` on a host-tier cache of ``data``: on ``train.mesh``,
    or on an explicit ``MeshContext(n_data, n_model, n_slices)``."""
    opt = _streamed_sgd(mesh, device, **kw)
    coef = opt.optimize(np.zeros(dim, np.float32), host_cache(data), _loss(loss))
    return {"coef": coef, "losses": np.asarray(opt.loss_history, np.float64),
            "premat": np.asarray(opt.onehot_premat_active)}


def sgd_streamed_killed_and_resumed(data: dict, dim: int, ckpt_dir: str, device: str,
                                    mesh: Tuple[int, int, int], other_mesh: Tuple[int, int, int], **kw) -> dict:
    """A streamed fit with a ``ShardedCheckpointManager`` on ``mesh``: clean,
    then resumed after its newest snapshot is deleted; the saved coefficient's
    shape; and whether a fit on ``other_mesh`` refuses the directory."""
    import shutil

    from flink_ml_tpu_torch.checkpoint import FingerprintMismatchError, ShardedCheckpointManager

    cache = host_cache(data)
    clean = _streamed_sgd(mesh, device, **kw).optimize(np.zeros(dim, np.float32), cache, _loss("logistic"))
    path = os.path.join(ckpt_dir, "x".join(map(str, mesh)))
    mgr = ShardedCheckpointManager(path)
    opt = _streamed_sgd(mesh, device, checkpoint_manager=mgr, checkpoint_interval=2, **kw)
    full = opt.optimize(np.zeros(dim, np.float32), cache, _loss("logistic"))
    steps = mgr.all_steps()
    saved = mgr.restore(steps[-1])
    dist.barrier()
    if dist.get_rank() == 0:
        shutil.rmtree(os.path.join(path, f"ckpt-{steps[-1]}"))
    dist.barrier()
    resumed = _streamed_sgd(mesh, device, checkpoint_manager=ShardedCheckpointManager(path),
                            checkpoint_interval=2, **kw).optimize(np.zeros(dim, np.float32), cache, _loss("logistic"))
    try:
        _streamed_sgd(other_mesh, device, checkpoint_manager=ShardedCheckpointManager(path),
                      checkpoint_interval=2, **kw).optimize(np.zeros(dim, np.float32), cache, _loss("logistic"))
        refused = 0
    except FingerprintMismatchError:
        refused = 1
    return {"clean": clean, "full": full, "resumed": resumed, "steps": np.asarray(steps),
            "saved_shape": np.asarray(np.asarray(saved["coef"]).shape), "refused": np.asarray(refused)}


def kmeans_streamed(points: np.ndarray, k: int, seed: int, iters: int, chunk_rows: int, device: str) -> dict:
    """``KMeans.fit_stream`` on a host-tier cache of ``points``."""
    from flink_ml_tpu_torch.metrics import MLMetrics, metrics
    from flink_ml_tpu_torch.models.clustering.kmeans import KMeans

    before = metrics.get(MLMetrics.TRAIN_GROUP, MLMetrics.TRAIN_SHARDED_FITS, 0)
    model = (KMeans().set_k(k).set_seed(seed).set_max_iter(iters)
             .fit_stream(host_cache({"features": points}, chunk=61), chunk_rows=chunk_rows, device=device))
    fits = metrics.get(MLMetrics.TRAIN_GROUP, MLMetrics.TRAIN_SHARDED_FITS, 0) - before
    return {"centroids": model.centroids, "weights": model.weights, "fits": np.asarray(fits)}


def online_kmeans(batches: list, k: int, seed: int, decay: float, device: str,
                  mesh: Optional[Tuple[int, int]] = None) -> dict:
    """``OnlineKMeans`` fed ``batches`` one version at a time: every
    version's centroids and weights stacked, and the sharded fits counted.
    With ``mesh`` the fit runs at ``train.mesh`` × ``train.mesh.model`` =
    ``mesh`` instead of the world's setting (restored after)."""
    from flink_ml_tpu_torch.config import Options, config
    from flink_ml_tpu_torch.metrics import MLMetrics, metrics
    from flink_ml_tpu_torch.models.clustering.online_kmeans import OnlineKMeans
    from flink_ml_tpu_torch.models.online import QueueBatchStream

    saved = (config.get(Options.TRAIN_MESH), config.get(Options.TRAIN_MESH_MODEL))
    if mesh is not None:
        config.set(Options.TRAIN_MESH, mesh[0])
        config.set(Options.TRAIN_MESH_MODEL, mesh[1])
    try:
        before = metrics.get(MLMetrics.TRAIN_GROUP, MLMetrics.TRAIN_SHARDED_FITS, 0)
        stream = QueueBatchStream()
        model = (OnlineKMeans().set_k(k).set_seed(seed).set_decay_factor(decay)
                 .set_random_initial_model_data(dim=batches[0]["features"].shape[1]).fit(stream, device=device))
        centroids, weights = [], []
        for batch in batches:
            stream.add(batch)
            assert model.advance(1) == 1
            centroids.append(model.centroids)
            weights.append(model.weights)
        fits = metrics.get(MLMetrics.TRAIN_GROUP, MLMetrics.TRAIN_SHARDED_FITS, 0) - before
    finally:
        for opt, value in zip((Options.TRAIN_MESH, Options.TRAIN_MESH_MODEL), saved):
            if value is None:
                config.unset(opt)
            else:
                config.set(opt, value)
    return {"centroids": np.stack(centroids), "weights": np.stack(weights), "fits": np.asarray(fits),
            "versions": np.asarray(model.version_history)}


def mlp_streamed(features: np.ndarray, labels: np.ndarray, hidden: int, iters: int, batch: int, seed: int,
                 window_rows: int, device: str) -> dict:
    """``MLPClassifier.fit_stream`` on a host-tier cache."""
    from flink_ml_tpu_torch.models.classification.mlp_classifier import MLPClassifier

    est = (MLPClassifier().set_hidden_layers(hidden).set_max_iter(iters).set_global_batch_size(batch)
           .set_seed(seed).set_tol(0.0))
    model = est.fit_stream(host_cache({"features": features, "labels": labels}), window_rows=window_rows,
                           device=device)
    out = {"losses": np.asarray(est.loss_history, np.float64)}
    for i, (W, b) in enumerate(model.params):
        out[f"W{i}"], out[f"b{i}"] = W, b
    return out


def torchrun_rows():
    rng = np.random.default_rng(21)
    X = rng.normal(size=(500, 6)).astype(np.float32)
    return X, (X @ np.linspace(-1.0, 1.0, 6) > 0).astype(np.float32)


def _torchrun_main(out_dir: str) -> None:
    from flink_ml_tpu_torch.config import Options, config

    torch.set_num_threads(1)
    config.set(Options.TRAIN_MESH, int(os.environ["WORLD_SIZE"]))
    X, y = torchrun_rows()
    coef = logistic_regression(X, y, iters=15, batch=128, device="cpu")["coef"]
    np.save(os.path.join(out_dir, f"torchrun_r{dist.get_rank()}.npy"), coef)
    dist.destroy_process_group()


if __name__ == "__main__":
    import sys

    _torchrun_main(sys.argv[1])
