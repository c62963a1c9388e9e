"""Pipeline (pp) parallelism: GPipe-style microbatch pipelining over a
'stage' mesh dimension, the port of :mod:`nsof_tpu.parallel.pipeline`.

Every rank of the mesh's ``axis`` owns one stage's parameters (slice ``s``
of ``stage_params``' leading dim).  The schedule runs ``M + S − 1`` ticks;
at tick ``t`` stage ``s`` processes microbatch ``m = t − s`` (a bubble, which
is skipped, when ``m`` is out of range) and hands its activation to stage
``s + 1`` through one ``dist.batch_isend_irecv``.  Utilisation is ``M / (M +
S − 1)``.  Per-microbatch side inputs that every stage reads (a correlation
pyramid) ride in ``micro_consts``, indexed locally by ``m`` on each rank, so
only the recurrent activation crosses between ranks.  At the end the last
stage's outputs are broadcast to every rank of the axis.

A tree here is a tensor, or a dict (keys in sorted order, as JAX orders
them), list or tuple of trees.

The flagship use is RAFT's weight-tied refinement loop
(:func:`make_raft_pp_flow`): the encoders and the correlation pyramid run
replicated, and the GRU iterations are split evenly over the stages.
"""

from __future__ import annotations

from typing import Any, Callable

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from nsof_tpu_torch.parallel.mesh import mesh_device

Tree = Any


def _leaves(tree: Tree) -> list[torch.Tensor]:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _leaves(t)]
    return [] if tree is None else [tree]


def _map(fn: Callable, tree: Tree) -> Tree:
    if isinstance(tree, dict):
        return {k: _map(fn, tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, t) for t in tree)
    return None if tree is None else fn(tree)


def _take(tree: Tree, i: int) -> Tree:
    """Slice ``i`` of every leaf's leading dim."""
    return _map(lambda x: x[i], tree)


def pipeline_stages(
    mesh: DeviceMesh,
    stage_fn: Callable[[Tree, Tree, Tree], Tree],
    stage_params: Tree,
    micro_inputs: Tree,
    micro_consts: Tree = None,
    axis: str = "stage",
) -> Tree:
    """Run ``S = size of axis`` stages over ``M`` microbatches.

    Args:
        stage_fn: ``(params_s, const_m, act) -> act``, returning the same
            tree of the same shapes and dtypes as ``act``.
        stage_params: tree whose leaves have leading dim ``S``; the rank at
            position ``s`` of ``axis`` uses slice ``s`` (pass
            :func:`tied_stage_params` for weight-tied loops).
        micro_inputs: tree with leading dim ``M``: microbatch ``m``'s first
            activation.
        micro_consts: optional tree with leading dim ``M`` of read-only
            per-microbatch side inputs, indexed locally.

    Returns the final activations, leading dim ``M``, on every rank of the
    axis: for each ``m`` the sequential composition ``stage_{S-1}(...
    stage_0(micro_inputs[m]))``.
    """
    group = mesh.get_group(axis)
    n_stages, s = dist.get_world_size(group), dist.get_rank(group)
    if not _leaves(micro_inputs):
        raise ValueError("micro_inputs must be a non-empty pytree")
    m_count = _leaves(micro_inputs)[0].shape[0]
    params = _take(stage_params, s)
    out = _map(torch.zeros_like, micro_inputs)
    recv = None
    for t in range(m_count + n_stages - 1):
        m = t - s
        act = None
        if 0 <= m < m_count:
            act_in = _take(micro_inputs, m) if s == 0 else recv
            const = _take(micro_consts, m) if micro_consts is not None else ()
            act = stage_fn(params, const, act_in)
            if s == n_stages - 1:
                for buf, a in zip(_leaves(out), _leaves(act)):
                    buf[m] = a
        ops = []
        if s < n_stages - 1 and act is not None:
            peer = dist.get_global_rank(group, s + 1)
            ops += [dist.P2POp(dist.isend, a.contiguous(), peer, group) for a in _leaves(act)]
        recv = None
        if s > 0 and 0 <= t + 1 - s < m_count:
            peer = dist.get_global_rank(group, s - 1)
            recv = _map(lambda x: torch.empty_like(x[0]), micro_inputs)
            ops += [dist.P2POp(dist.irecv, r, peer, group) for r in _leaves(recv)]
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
    last = dist.get_global_rank(group, n_stages - 1)
    for buf in _leaves(out):
        dist.broadcast(buf, src=last, group=group)
    return out


def tied_stage_params(params: Tree, n_stages: int) -> Tree:
    """One parameter set stacked ``n_stages`` times along a new leading
    dim (a broadcast view, no copy): every stage of a weight-tied pipeline
    runs the same weights."""
    return _map(lambda x: x[None].expand((n_stages,) + tuple(x.shape)), params)


# ── RAFT: iterations as stages ─────────────────────────────────────────────


def make_raft_pp_flow(mesh: DeviceMesh, cfg=None, iters: int | None = None,
                      axis: str = "stage"):
    """Pipeline-parallel RAFT inference: the GRU refinement loop split into
    ``S`` stages of ``iters / S`` iterations each, microbatches of image
    pairs flowing through.

    The prologue (normalisation, feature and context encoders, all-pairs
    correlation and its pyramid) runs replicated on every rank; the
    recurrent activation (``net``, ``coords1`` and, for RAFT-basic, the
    upsampling mask) crosses between ranks, and each microbatch's pyramid,
    context features and base grid ride ``micro_consts``.

    Returns ``fn(model, image1, image2) -> flow_up`` for a port
    :class:`~nsof_tpu_torch.models.raft.RAFT` of config ``cfg`` on this
    rank's device, with ``image*: [M, B, H, W, 3]`` (M microbatches) and
    ``flow_up: [M, B, H, W, 2]``: per microbatch the unsharded
    ``model(image1[m], image2[m], iters=iters, test_mode=True)[1]``.
    Raises ``ValueError`` when ``iters`` does not divide by the stages and
    ``NotImplementedError`` for ``corr_mode='alternate'``.
    """
    from torch.func import functional_call

    from nsof_tpu_torch.models.raft import (RAFT, RaftConfig, all_pairs_correlation,
                                            build_corr_pyramid, coords_grid, corr_lookup)

    cfg = cfg or RaftConfig()
    if cfg.corr_mode == "alternate":
        raise NotImplementedError(
            "pp pipeline uses the all-pairs corr pyramid as a microbatch "
            "constant; corr_mode='alternate' is not supported here"
        )
    n_stages = mesh.size(mesh.mesh_dim_names.index(axis))
    iters = iters or cfg.iters
    if iters % n_stages != 0:
        raise ValueError(f"iters ({iters}) must divide by stages ({n_stages})")
    k = iters // n_stages
    dev = mesh_device(mesh)
    hdim = cfg.hidden_dim

    def run(model: RAFT, image1, image2):
        update = model.update_block

        def stage_fn(uparams, const, act):
            net, coords1, up_mask = act["net"], act["coords1"], act.get("up_mask")
            coords0, inp = const["coords0"], const["inp"]
            for _ in range(k):
                corr = corr_lookup(const["pyramid"], coords1, cfg.corr_radius).permute(0, 3, 1, 2)
                flow = (coords1 - coords0).permute(0, 3, 1, 2)
                with model._autocast(dev):
                    net, mask, delta = functional_call(update, uparams, (net, inp, corr, flow))
                coords1 = coords1 + delta.float().permute(0, 2, 3, 1)
                if mask is not None:
                    up_mask = mask.float()
            out = {"net": net, "coords1": coords1}
            if up_mask is not None:
                out["up_mask"] = up_mask
            return out

        with torch.no_grad():
            i1 = torch.as_tensor(image1).to(dev)
            i2 = torch.as_tensor(image2).to(dev)
            m, b, h, w, _ = i1.shape
            img1 = (2.0 * (i1.reshape(m * b, h, w, 3).float() / 255.0) - 1.0).permute(0, 3, 1, 2)
            img2 = (2.0 * (i2.reshape(m * b, h, w, 3).float() / 255.0) - 1.0).permute(0, 3, 1, 2)
            with model._autocast(dev):
                fmaps = model.fnet(torch.cat([img1.contiguous(), img2.contiguous()])).float()
                cmap = model.cnet(img1.contiguous())
                net = torch.tanh(cmap[:, :hdim])
                inp = torch.relu(cmap[:, hdim:])
            fmap1 = fmaps[:m * b].permute(0, 2, 3, 1)
            fmap2 = fmaps[m * b:].permute(0, 2, 3, 1)
            _, h8, w8, _ = fmap1.shape
            # each level [(M·B)·h8·w8, hl, wl] split into M microbatches, so a
            # slice is the [B·h8·w8, hl, wl] layout corr_lookup reads
            pyramid = [c.reshape((m, c.shape[0] // m) + c.shape[1:]) for c in
                       build_corr_pyramid(all_pairs_correlation(fmap1, fmap2), cfg.corr_levels,
                                          cfg.corr_pool)]
            coords = coords_grid(m * b, h8, w8, dev).reshape(m, b, h8, w8, 2)
            act = {"net": net.reshape((m, b) + net.shape[1:]), "coords1": coords.clone()}
            if not cfg.small:
                act["up_mask"] = torch.zeros((m, b, 64 * 9, h8, w8), device=dev)
            consts = {"coords0": coords, "inp": inp.reshape((m, b) + inp.shape[1:]),
                      "pyramid": pyramid}
            params = tied_stage_params(dict(update.named_parameters()), n_stages)
            out = pipeline_stages(mesh, stage_fn, params, act, consts, axis=axis)
            flow8 = out["coords1"] - coords
            up = [RAFT._upsample(flow8[i], out["up_mask"][i] if not cfg.small else None)
                  for i in range(m)]
            return torch.stack(up)

    return run
