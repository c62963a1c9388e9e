"""The algorithms of K8 (``csrc/device_scan.cu``) and K9 (``csrc/nms.cu``),
mirrored here in PyTorch on the CPU, against the plain versions they must
equal bit for bit and against the JAX package.

- K8: the per-cell scan with its exact exit at the fixed point (a pair's
  substeps stop once a step returns the state's own bits; the dead zone
  takes one step).  At n_substeps 1000 on a 12×16 grid, 4 pairs, with
  ``chip_smoke.py``'s K8 inputs (mixed lanes that clamp to 0 or 1 early
  beside cells with random drives that transition through whole pairs, the
  dead zone, powf drives) and ``w0`` holding exact 0, 1, -0.0 and NaN: equal to
  ``scan_device_plain`` bit for bit, with fewer substeps than the plain
  loop's; and against the jitted JAX ``_scan_device_maps`` at
  ``tests/test_torch_device.py``'s limits (``w_final`` within 2e-6,
  ``mem_gray`` within one level and equal at ≥ 99 % of cells).
- K9: rank (torch.argmax's order on the valid boxes), the suppression mask
  of ranks r < q, the walk over 32-bit words (the next rank not removed is
  kept and ORs its row into the removed bits), and the greedy loop itself
  for a row with a valid -inf score.  On ``chip_smoke.K9_CASES`` up to
  N = 1,500 (ties, NaN, zero areas, the class offset, inclusive widths, none
  and every candidate, -inf scores; the N = 8,192 case is a random one, its
  N × N float matrices here would take gigabytes) and on a row built so
  that the plain loop keeps a dead box: equal to ``nms`` and to the JAX
  package's ``nms`` (vmapped over the batch).  On that row the walk alone
  differs from ``nms``, which is why the kernel takes the greedy loop
  there.
"""

import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import K9_CASES, K9_IOU, k9_inputs
from nsof_tpu.ops import components as jcc
from nsof_tpu.pipelines.stream import _scan_device_maps as j_scan
from nsof_tpu.device import frame_sim as jfs
from nsof_tpu.device.model import DEFAULT_PARAMS as J_DEFAULT_PARAMS
from nsof_tpu_torch.device import frame_sim as tfs
from nsof_tpu_torch.device.model import (DEFAULT_PARAMS, _rdiv, conductance_to_gray,
                                         difference_voltage, modulate_voltage, resistance_exp,
                                         update_state)
from nsof_tpu_torch.ops import components as tcc
from torch_single_thread import one_torch_thread  # noqa: F401  (autouse)

K8_GRID, K8_PAIRS, K8_SUBSTEPS = (12, 16), 4, 1000


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32) if t.dtype == torch.float32 else t


# ── K8 ──


def k8_mirror(frames01: torch.Tensor, sim: tfs.FrameSimConfig, w0: torch.Tensor):
    """K8's scan, cell by cell in lockstep: each pair's substeps stop for a
    cell once a step returns its state's own bits; the dead zone takes one
    step.  Returns (w_final, mem_gray, states, substeps each cell ran)."""
    p = sim.params
    scaled = frames01.to(torch.float32) * 256.0
    dt_sub = sim.dt / sim.n_substeps
    w = w0.to(torch.float32).clone()
    ran = torch.zeros(w.shape, dtype=torch.int64)
    grays, states = [], []
    for t in range(scaled.shape[0] - 1):
        v_mod = modulate_voltage(difference_voltage(scaled[t], scaled[t + 1],
                                                    sim.th1, sim.th2))
        running = (v_mod < p.v_off) | (v_mod > p.v_on)
        if sim.n_substeps > 0:  # the dead zone's one step
            w = torch.where(running, w, update_state(w, v_mod, p, dt_sub))
            ran += ~running
        for _ in range(sim.n_substeps):
            if not running.any():
                break
            w_new = update_state(w, v_mod, p, dt_sub)
            ran += running
            fixed = _bits(w_new) == _bits(w)
            w = torch.where(running, w_new, w)
            running &= ~fixed
        states.append(w)
        grays.append(conductance_to_gray(_rdiv(1.0, resistance_exp(w, p))))
    return w, torch.stack(grays), torch.stack(states), ran


def k8_inputs(kind: str, seed: int):
    """``chip_smoke.k8_inputs``'s kinds at K8_GRID and K8_PAIRS: frames in
    [0, 1] whose |Δ|·256 spans [0, 12], edited as ``kind`` says, and w0
    with exact 0, 1, -0.0 and a NaN in a few cells."""
    gh, gw = K8_GRID
    rng = np.random.default_rng(seed)
    steps = rng.uniform(0, 12, (K8_PAIRS, gh, gw)) * rng.choice([-1, 1], (K8_PAIRS, gh, gw))
    w0 = rng.random((gh, gw))
    if kind == "mixed":
        third = np.arange(gh * gw).reshape(gh, gw) % 3
        steps[:, third == 0] = 0.0
        steps[:, third == 1] = 12.0 * (-1.0) ** np.arange(K8_PAIRS)[:, None]
        w0[third == 0], w0[third == 1] = 0.01, 0.9999
    frames = np.concatenate([rng.uniform(0.1, 0.9, (1, gh, gw)), steps / 256]).cumsum(0)
    w0 = w0.astype(np.float32)
    w0.flat[3::11], w0.flat[4::11], w0.flat[5::11] = 0.0, 1.0, -0.0
    w0[1, 2] = np.nan
    return np.clip(frames, 0, 1).astype(np.float32), w0


K8_KINDS = {
    "mixed_lanes": ({}, "mixed"),
    "dead_zone_th1_6": ({"th1": 6.0}, "random"),
    "alpha_2_1.5": ({"alpha_off": 2.0, "alpha_on": 1.5}, "random"),
}


@functools.lru_cache(maxsize=None)
def _k8_case(name: str):
    """K8_KINDS[name]'s inputs, its config changes, its FrameSimConfig and
    the mirror's outputs on them."""
    changes, kind = K8_KINDS[name]
    params = {k: v for k, v in changes.items() if k.startswith("alpha")}
    sim = tfs.FrameSimConfig(m=20, n=20, n_substeps=K8_SUBSTEPS,
                             params=dataclasses.replace(DEFAULT_PARAMS, **params),
                             **{k: v for k, v in changes.items() if k not in params})
    frames, w0 = k8_inputs(kind, seed=len(name))
    return frames, w0, changes, sim, k8_mirror(torch.from_numpy(frames), sim,
                                               torch.from_numpy(w0))


@pytest.mark.parametrize("name", sorted(K8_KINDS))
def test_k8_fixed_point_exit_equals_plain_scan(name):
    frames, w0, _, sim, got = _k8_case(name)
    ref = tfs.scan_device_plain(torch.from_numpy(frames), sim, torch.from_numpy(w0),
                                keep_states=True)
    for part, g, r in zip(("w_final", "mem_gray", "states"), got[:3], ref):
        assert g.dtype == r.dtype and g.shape == r.shape, part
        assert torch.equal(_bits(g), _bits(r)), part
    ran = got[3]
    assert torch.isnan(got[0][1, 2]) and ran.max() <= K8_PAIRS * K8_SUBSTEPS
    assert ran.sum() < K8_PAIRS * K8_SUBSTEPS * ran.numel()  # the exit saved steps


@pytest.mark.parametrize("name", sorted(K8_KINDS))
def test_k8_fixed_point_exit_matches_jax(name):
    frames, w0, changes, _, (w_t, gray_t, _, _) = _k8_case(name)
    params = {k: v for k, v in changes.items() if k.startswith("alpha")}
    sim_j = jfs.FrameSimConfig(m=20, n=20, n_substeps=K8_SUBSTEPS,
                               params=dataclasses.replace(J_DEFAULT_PARAMS, **params),
                               **{k: v for k, v in changes.items() if k not in params})
    ref_w, ref_gray = (np.asarray(a) for a in
                       jax.jit(j_scan, static_argnums=1)(frames, sim_j, w0))
    np.testing.assert_allclose(w_t.numpy(), ref_w, rtol=0, atol=2e-6)
    d = np.abs(gray_t.numpy().astype(int) - ref_gray.astype(int))
    assert d.max() <= 1, d.max()
    assert (d == 0).mean() >= 0.99, (d == 0).mean()


# ── K9 ──


def _argmax_key(score: float, i: int):
    """torch.argmax's order as a sort key, larger first: NaN, then the
    score (-0.0 equal to 0.0), then the lower index."""
    return (1, 0.0, -i) if math.isnan(score) else (0, score, -i)


def k9_walk(boxes: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor,
            iou_thresh: float, plus_one: bool) -> torch.Tensor:
    """One row of K9 without its greedy loop: rank, mask, walk.  ``[N, 4]``,
    ``[N]``, ``[N]`` → the ``[N]`` keep mask."""
    n = scores.shape[0]
    one = 1.0 if plus_one else 0.0
    ids = [i for i in range(n) if bool(valid[i])]
    order = sorted(ids, key=lambda i: _argmax_key(float(scores[i]), i), reverse=True)
    nv, words = len(order), (len(order) + 31) // 32
    keep = torch.zeros(n, dtype=torch.bool)
    if nv == 0:
        return keep
    # the mask: the plain version's IoU, the earlier rank as the pick
    x1, y1, x2, y2 = boxes.float()[order].unbind(-1)
    areas = (y2 - y1 + one) * (x2 - x1 + one)
    ww = (torch.minimum(x2[:, None], x2[None]) - torch.maximum(x1[:, None], x1[None])
          + one).clamp(min=0.0)
    hh = (torch.minimum(y2[:, None], y2[None]) - torch.maximum(y1[:, None], y1[None])
          + one).clamp(min=0.0)
    inter = ww * hh
    iou = inter / (areas[:, None] + areas[None] - inter)
    rank = torch.arange(nv)
    sup = ((iou > iou_thresh) & (rank[None] > rank[:, None])).numpy()
    # row r's bits packed into 32-bit words, bit q % 32 of word q // 32
    sup = np.pad(sup, ((0, 0), (0, 32 * words - nv))).reshape(nv, words, 32)
    mask = (sup.astype(np.uint64) << np.arange(32, dtype=np.uint64)).sum(-1).tolist()
    # the walk: one 32-bit word at a time
    removed = [0] * words
    for x in range(words):
        live = (1 << (nv - 32 * x)) - 1 if nv - 32 * x < 32 else 0xFFFFFFFF
        cur = ~removed[x] & live
        while cur:
            bit = (cur & -cur).bit_length() - 1
            r = 32 * x + bit
            keep[order[r]] = True
            cur &= ~mask[r][x] & ~((2 << bit) - 1) & 0xFFFFFFFF
            for y in range(x + 1, words):
                removed[y] |= mask[r][y]
    return keep


def k9_mirror(boxes, scores, valid, iou_thresh, plus_one=True) -> torch.Tensor:
    """K9 on ``[B, N, 4]``, ``[B, N]``, ``[B, N]``: a row with a valid -inf
    score runs the greedy loop (the plain loop itself), any other the walk."""
    rows = []
    for b in range(scores.shape[0]):
        if bool((valid[b].bool() & (scores[b].float() == -math.inf)).any()):
            rows.append(tcc.nms(boxes[b : b + 1], scores[b : b + 1], valid[b : b + 1],
                                iou_thresh, plus_one)[0])
        else:
            rows.append(k9_walk(boxes[b], scores[b], valid[b], iou_thresh, plus_one))
    return torch.stack(rows)


def _jax_nms(boxes, scores, valid, iou_thresh, plus_one):
    return np.asarray(jax.vmap(lambda bx, s, v: jcc.nms(bx, s, v, iou_thresh, plus_one))(
        jnp.asarray(boxes.numpy()), jnp.asarray(scores.numpy()), jnp.asarray(valid.numpy())))


def _dead_box_row():
    """A row where the plain loop keeps a dead box: box 0 is no candidate,
    box 1 is one with a -inf score and does not overlap it, so every step's
    argmax ties them at -inf and picks box 0."""
    boxes = torch.tensor([[[0.0, 0.0, 10.0, 10.0], [50.0, 50.0, 60.0, 60.0]]])
    return boxes, torch.tensor([[0.5, -math.inf]]), torch.tensor([[False, True]])


@pytest.mark.parametrize("name", sorted(n for n, case in K9_CASES.items() if case[1] <= 1500))
def test_k9_rank_mask_walk_equals_nms_and_jax(name):
    boxes, scores, valid, plus_one = k9_inputs(name, "cpu")
    got = k9_mirror(boxes, scores, valid, K9_IOU, plus_one)
    ref = tcc.nms(boxes, scores, valid, K9_IOU, plus_one)
    assert got.dtype == torch.bool and torch.equal(got, ref)
    np.testing.assert_array_equal(got.numpy(), _jax_nms(boxes, scores, valid, K9_IOU,
                                                         plus_one))


def test_k9_greedy_loop_for_a_dead_pick():
    boxes, scores, valid = _dead_box_row()
    ref = tcc.nms(boxes, scores, valid, K9_IOU, True)
    assert ref.tolist() == [[True, False]]  # the plain loop keeps the dead box 0
    assert torch.equal(k9_mirror(boxes, scores, valid, K9_IOU, True), ref)
    np.testing.assert_array_equal(ref.numpy(), _jax_nms(boxes, scores, valid, K9_IOU, True))
    walk = k9_walk(boxes[0], scores[0], valid[0], K9_IOU, True)
    assert walk.tolist() == [False, True]  # the walk alone would keep box 1
