#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA card: build the hand-written
kernels, hold each against its plain version, serve recommendations with the
full-width Medium model, train it, search, and run the CLIs from raw logs.

Run from the repository root on a CUDA host (one card)::

    python3 chip_smoke.py

Phases, one line each; a failing phase raises and the exit code is not 0:

1. device: the card's name and power limit, torch and CUDA versions.
2. build: ``nvcc`` of ``gnn_recsys_tpu_torch/csrc/*.cu`` for sm_90a (one
   process a source, all at once), with the compiler's register /
   shared-memory / spill summary; the instantiations the main path runs
   (``NO_SPILL``: the leaf kernels' f32 and bf16 F = 8; the gather-mean
   kernels' f32 and bf16 16-byte paths at K = 8 and 4, and the full-fanout
   design's forward at K > 32 and backward kernels; ``topk_kernel``'s f32
   top-k and boost epilogues with lists in the shared buffer and its LSE
   epilogue; the pool mask; the head's tower's bf16 forward, dW2 pass and
   sums) must not spill.
3. kernels: each kernel against its plain version; its time (``ms``: the
   device time of its kernels under ``torch.profiler``; ``events_ms``: CUDA
   events around back-to-back calls, host overhead included) beside the
   bound, the plain version's device time and, where one PyTorch call
   computes the same function, that call's.  The MIPS kernels at a serving shape (U=4096 users,
   I=30,000 items, D=128, k=26), a tied case, a bf16 case, D=33 (zero-padded
   to 36); ``mips_lse`` and ``mips_boost`` also at k=100 with U=4093, k =
   ``max_k()``, a catalog of 11 items and k=266 (from a generator of their
   own), ``mips_topk`` too where k > 32;
   ``leaf_mean_nn``
   forward and backward at the training step's widest leaf (P=18,432, K=8,
   F=8, H=256) in f32 and bf16 (rows ``leaf_mean_nn_*:bf16``), a ragged P
   and an all-masked row, the backward's main kernel and its reduce timed
   apart (the backward may differ beyond ``GRAD_REL`` only by the terms
   whose pre-activation lies within rounding of 0, ``leaf_bwd_slack``);
   ``pool_membership_mask`` at [1024, 32, 2560] with -1 padding, ragged
   B and P, P = 2557, K = 128, and repeated ids with negative pool
   entries, bit for bit; ``gather_mean`` forward and backward on uniform random ids at
   the dedup step's widest mean (B=38,912, K=8, N=30,000, D=256) and a
   ragged B, with an all-masked row and ids of -1 and >= N among the valid
   slots; the backward against both plain versions (the walk of the same
   transpose, and ``index_add_``) and against a second call (same bits),
   and also timed with the wrapper's own sort (``without_plan_ms``); the
   forward again on ids inside the table's first 4 MB (``l2_resident_ms``);
   then both in bf16 (rows ``gather_mean_*:bf16``, within ``BF16_RTOL`` of
   the largest entry, the backward's bits twice the same); then both at the
   CLI drill's widest user table (B=904, K=1,280, N=3,000, D=256) on skewed
   ids with every masked slot on one row, as the dedup'd plan has them, the
   backward through that plan's kind of transpose (rows
   ``gather_mean_*:wide:…`` and ``gather_mean_*:bf16:wide:…``; launches: the
   drill's at K > 32 in f32, phase 10's bf16 ones in bf16, since no path runs
   bf16 at K > 32); the LSTM cell update's forward and backward at H = 256,
   in f32 at N = 18,432 rows and in bf16 at each N of the bf16 LSTM step
   (2,048, 4,608, 8,192, 18,432), bf16 within one ulp of the plain version
   and bit-equal on 99.9% of the elements (rows ``lstm_cell_*`` and
   ``lstm_cell_*:bf16``, timed at N = 18,432 beside PyTorch's fused LSTM
   cell); the MLP head's tower over the dense pool's cross form at the
   bench step's B = 1,024 users and P = 2,560 pool items, forward and
   backward: f32 (a ``kernel_case`` line) on inputs whose pre-activations
   stay away from zero, and bf16 (rows ``pred_tower_*:bf16``) on free
   inputs, beside the unfactorised concat head the port ran before
   (``pred_tower_rows``).
4. slice: the 100k-user / 30k-item synthetic graph of ``bench.py``, the
   Medium ``ConvModel`` (hidden 256, out 128, mean_nn, cos, 2 conv layers)
   with seeded random weights saved as a run; requests of 1, 128 and 4096
   users through ``inference_ondemand`` (and 4096 with the popularity
   boost), then ``get_metrics_at_k`` over every test user; ranking all 100k
   users alone, with and without the boost, timed against the plain
   versions.  The kernels' launch counters must grow, every rec is a catalog
   id or -1, no already-bought item is recommended, and the kernel route
   agrees with the ``torch`` route.
4b. sharded_serving: the same Medium model and graph served with the
   catalog split over meshes of 4 and 7 shards that all sit on the card (7
   leaves a padded last shard): every user ranked through
   ``get_recs_sharded`` on the kernel route, plain and boosted, against
   single-device ``get_recs`` (plain: every row equal to the kernel
   route's; both: against the torch route with the near-tie rule), each
   MIPS kernel's launches grown by exactly the shard count a call; one
   4,096-user ``inference_ondemand`` request with a mesh of 4 against the
   request without one, and its seconds by part (the rebuild of capped
   rows among them); ``infer_embeddings_sharded`` of the whole graph against
   ``compute_embeddings`` within the JAX package's tolerance (rtol 2e-5,
   atol 2e-6), once more with a ``leaf_kernel=True`` copy of the model, whose
   leaf-forward launches must equal the count from the tree's shape;
   ``main_inference --mesh 1`` in a process of its own against the CLI run
   without it; then each mesh's ranking, each shard's ``mips_topk`` and the
   merge timed alone.  Where the host has several cards, the same ranking and
   embedding pass over all of them (one shard a card), and whether the
   shards overlapped (the call's wall time against the sum of the shards'
   kernel times).  ``python3 phase_compare.py sharded_serving .`` runs the
   build and this phase alone.
5. train: the ``bench.py`` training step (dense pool of 2560, fanouts (8, 4),
   2048 edges a batch, batch-edge exclusion, max-margin loss, Adam) with the
   leaf and pool-mask kernels, about 200 steps on the same graph and model:
   median step time (CUDA events, batch assembly included), edges a second
   (all steps' edges over their host time), peak memory, the loss curve, launch
   counts that must grow by the exact per-step count, then 5 steps under
   ``torch.profiler`` (device time by kernel group, idle share); one step of
   the kernel route against the plain route (same parameters and draws);
   the trained model's recall@10, which must beat the random weights' of
   phase 4.
6. train_dedup: the same step through the dedup'd block forward
   (``MinibatchConfig(dedup=True)``), about 50 steps from fresh random
   weights, its gather-mean calls through a :class:`GatherTap`: the same
   report, launch counts of exactly 8 / 8 / 2 / 0 a step (gather-mean
   forward / backward, pool mask, leaf) and the gather-mean calls by shape;
   one step of the kernel route against the plain route (the tap calls the
   forward's plain version for that step); two more kernel steps from the
   same parameters, batch and draws, whose gradients must be bit-identical.
7. gather_plan: both gather-mean kernels on the captured step's own plan,
   at each of the four shapes it runs (levels 1 and 2, users and items):
   per call the destination table's unique count and padding rows, the
   masked share and the valid slots per source row with and without the
   padding rows; per shape the checks and times of phase 3 (one row each in
   the kernels line, with its launches in the main path) and the forward
   again on ids inside the table's first 4 MB (``l2_resident_ms``); then
   the same in bf16 (the table and cotangent rounded to bf16; rows
   ``gather_mean_*:bf16:<shape>``, whose launches are phase 10's).
8. packed_leaf: one tree forward at fanouts (-1, -1) for 32 users and 32
   items through the packed leaf cache (``attach_leaf_features``) and
   without it.
9. train_graph and train_graph_dedup: the same step through the trainer's
   entry point, ``train_minibatch`` with ``MinibatchConfig(device_epoch=True)``,
   where each step is one replay of a CUDA graph of the whole step (epochs
   permuted and sliced on the card): three epochs on edge slices of the
   bench graph (the 10-step loss-only pass, then 100 training steps an epoch
   for the tree and 25 for the dedup'd forward, and 10 validation steps an
   epoch).  Steps, edges a second, the median training replay (CUDA
   events), peak memory, the epochs' losses (they must fall), and the launch
   counts, which must equal each kernel's launches a step times the steps
   run (the captures' warm-up steps included; each replay adds its captured
   launches to the wrappers' counters).  Then ``check_steps`` (10) steps of
   the eager body against as many replays from one state and seed: the
   first step's draws bit for bit, losses within 1e-5, parameters within
   the Adam tolerance after each update, the graph's captured launches equal
   to a step's; and 5 replays under ``torch.profiler`` (device time, kernels
   and idle share a step, and each training kernel's launches a replay from
   the kernel records).  Phases 5 and 6 are the eager host loop of the same
   step, timed in the same run.
10. train_graph_bf16 and train_graph_dedup_bf16: phase 9 with the bench
   config as ``bench.py:219-231`` defines it, ``ConvModel(dtype=bfloat16)``:
   the same report, each templated training kernel's launches a replay in
   its bf16 instantiation, the eager-against-graph check at the bf16
   tolerances of ``tests/test_torch_bf16.py`` (losses within 1e-2,
   gradients within 5e-2 of each parameter's largest entry, parameters
   within 2 * lr: the dedup step's ``index_add_`` adds bf16 cotangents with
   atomics), and recall@10 after training, which must beat the random
   weights' of phase 4.  Then ``train_graph_nn_bf16``: the tree step of
   phase 10 with the MLP head (``pred='nn'``), whose dense pool runs the
   tower kernels (two forward and two backward launches a step; no recall
   check: the cosine ranking does not rank for that head).
11. train_full_batch: BASELINE config[0] (2-layer mean GraphSAGE,
   full-batch, recall@10) at the Medium width (hidden 256, out 128, cosine
   head, dropout 0) through ``train_full_batch`` on the bench generator's
   graph at 10,000 users and 3,000 items: ``FullBatchConfig`` defaults (63
   uniform negatives a positive, false negatives masked, delta 0.266, lr
   1e-3), 30 epochs, evaluating every 10 (recall@10 through ``mips_topk``).
   Each epoch's step time (the trainer's own), peak memory, the loss curve
   (it must fall), recall@10 (it must beat the random weights') beside the
   popularity baseline's, the ``mips_topk`` launches of the phase (they must
   be more than 0); the trained model's evaluation recs ranked through
   ``mips_topk`` and through the torch route, which must agree but at
   near-ties (``eval_routes_check``); 3 steps between CUDA events and 3
   under ``torch.profiler``; then one step on the card against the same
   step on the CPU at 500 users, from one state with the card's negatives
   replayed: loss, gradients and update; the card's gradients also against
   the same step in f64 on the CPU, and the card's step run twice
   (``full_batch_step_check``).
12. train_full_batch_nn: the same with the MLP head (``pred='nn'``) at 5,000
   users and 1,500 items, 20 epochs; then the trained model is saved with
   ``save_run`` and serves one ``inference_ondemand`` request for 128 users
   on the card (latency and its ``load_run`` share), held against the same
   request on the CPU (``serve_nn_run``).

13. hp_search: three trials of the port's hyperparameter search
   (``run_search(optimizer="gp", seed=46)``) on the hard synthetic world of
   ``benchmarks/hp_search_hard.py`` (20,000 users, 6,000 items,
   ``max_fanout=32``), each trial ``trial.run_trial_on_graph`` (split,
   ``build_model``, ``minibatch_config``, ``train_minibatch`` through the
   device epochs for ``FixedParams(num_epochs=2)``, recall@10 with the
   popularity boost where the trial serves with it): one ``hp_trial`` line
   a trial (seconds of each part, the replayed step, profile, peak memory
   and memory left after the trial, losses, recall@10 against the initial
   weights', launches, the gather-mean kernels' launches by shape, the
   dropout check of :func:`dropout_replay_check`), each trial's kernels
   held against their plain versions at its own shapes (the evaluation's
   ranking through ``mips_topk`` or ``mips_lse`` + ``mips_boost`` against
   the torch route, ``eval_routes_check``; both gather-mean kernels on one
   step's plan, rows ``gather_mean_*:hp<trial>:B…_K…_N…_D…``), then the
   proposals held against :data:`HP_TRIALS` and a resumed search that must
   run no trial.
14. etl_cli: the JAX package's CLI drill (``benchmarks/e2e_drift_cli.py``)
   from raw CSV logs, in process through each CLI's ``main(argv)``:
   ``make_drift_logs`` (3,000 users, 900 items, 90,000 interactions), the
   rows after each date window (each must drop rows), the 14-day presplit,
   ``main_hp`` (2 trials of 3 epochs, ``--remove 0.3``, 1,024 edges a
   batch), the best hyperparameters to JSON, ``main_train`` (3 epochs), and
   ``main_inference`` for three named users (k 10) and ``--all`` (k 5); one
   ``etl_trial`` line a trial (the seconds of each ETL stage and of the
   split, build, training, evaluation and in-loop inference evaluation,
   nodes, edges, recall); the run directory's artifacts, k external item ids
   a named user and more than half the users under ``--all`` asserted; the
   saved run's embeddings ranked through the kernels against the torch
   route, and the first dedup'd trial's gather-mean plan against the plain
   versions (rows ``gather_mean_*:etl:…``).

15. train_lstm: the Medium model with ``aggregator_type="lstm"`` in bf16
   (the bench config's computation dtype) through ``train_minibatch`` and
   its device epochs, the bench step (dense pool of 2560, fanouts (8, 4),
   2048 edges a batch, batch-edge exclusion, max-margin loss, Adam), three
   short epochs on edge slices of the bench graph (the 10-step loss-only
   pass, 20 training steps an epoch, 4 validation steps an epoch): the
   median replay (CUDA events), edges a second, peak memory, the losses
   (they must fall), the pool mask's launches (one an etype a step, the
   captures' warm-ups included; no leaf or gather-mean launch), the LSTM
   cell kernels' (each K a reducer call, the backward's in training steps
   only; the reducer's count of its cell updates 112 a step); the eager
   body against as many replays at the bf16 tolerances, 5 profiled replays
   (device time by kernel group, idle share); recall@10 after training,
   which must beat the same model's random weights'; then the run saved
   and served (``inference_ondemand`` for 128 users, plain and boosted:
   latency and its ``load_run`` share), its ranking through ``mips_topk``
   and ``mips_lse`` + ``mips_boost`` held against the torch route.
16. train_lstm_edge_dedup: the same with ``lstm_edge`` in f32 through the
   dedup'd block forward (``MinibatchConfig(dedup=True)``), and two
   gradient computations from the same parameters, batch and draws
   (whether they are the same bits, and the largest gap).
17. remat: phase 15's tree step with ``remat_levels`` False and True, from
   one state and seed, each captured and replayed 10 times: the first
   replay's loss and gradients against each other (the same bits where
   they are), each run's peak memory (remat's must be lower) and median
   replay; then the pair at dropout 0.5 for 2 replays, checked alike; the
   cell updates of each run (remat's recompute adds some) and the LSTM cell
   kernels' launches.

Then a ``{"kernels": [...]}`` JSON line (each training kernel's row also
gives its launches in phase 9, ``graph_launches``, ``mips_topk``'s its
launches in phase 11, ``full_batch_launches``, each kernel of phase 13 its
launches there, ``hp_search_launches``, of phase 14, ``etl_cli_launches``,
and the pool mask's and the three MIPS epilogues' rows their launches in
phases 15 to 17, ``train_lstm_launches``, ``train_lstm_edge_dedup_launches``
and, the pool mask's, ``remat_launches``; the LSTM cell's f32 rows their
launches in phase 16, its bf16 rows theirs in phases 15 and 17; the three MIPS epilogues' and the
leaf forward's rows their launches in phase 4b, ``sharded_serving_launches``),
the card's name and power limit,
and the last line ``{"ok": true, "device": {...}}``.  Exits non-zero without
a CUDA device.
"""

from __future__ import annotations

import collections
import contextlib
import copy
import dataclasses
import functools
import importlib.util
import io
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np
import torch

from gnn_recsys_tpu_torch.cli import main_inference
from gnn_recsys_tpu_torch.config import ColumnConfig, FixedParams, HyperParams
from gnn_recsys_tpu_torch.data import etl
from gnn_recsys_tpu_torch.data.io import read_data, write_csv
from gnn_recsys_tpu_torch.data.presplit import presplit_data
from gnn_recsys_tpu_torch.data.table import Table
from gnn_recsys_tpu_torch.graph.hetero import attach_leaf_features, uncap
from gnn_recsys_tpu_torch.hpsearch import run_search
from gnn_recsys_tpu_torch.inference import (already_bought_from_graph, bought_table,
                                            inference_ondemand)
from gnn_recsys_tpu_torch.models import conv_model
from gnn_recsys_tpu_torch.models.conv_model import ConvModel
from gnn_recsys_tpu_torch.models.layers import MaskedLSTMReducer, PredictingLayer, l2_normalize
from gnn_recsys_tpu_torch.ops.cuda import build
from gnn_recsys_tpu_torch.ops.cuda import gather_mean as gm
from gnn_recsys_tpu_torch.ops.cuda import leaf_agg as la
from gnn_recsys_tpu_torch.ops.cuda import lstm_cell as lc
from gnn_recsys_tpu_torch.ops.cuda import pool_mask as pm
from gnn_recsys_tpu_torch.ops.cuda import pred_tower as pt
from gnn_recsys_tpu_torch.ops.cuda import topk_mips as tm
from gnn_recsys_tpu_torch.ops.membership import build_padded_pair_set, scatter_row_mask
from gnn_recsys_tpu_torch.ops.sampling import Draws, ReplayDraws
from gnn_recsys_tpu_torch.retrieval.metrics import get_metrics_at_k, recs_to_metrics
from gnn_recsys_tpu_torch.parallel import distributed
from gnn_recsys_tpu_torch.parallel.mesh import Mesh, make_mesh
from gnn_recsys_tpu_torch.parallel.sharded import (
    hash_shard_table,
    make_shardmap_dp_step,
    make_shardmap_tp_dp_step,
    shard_adjacency,
    strip_adjacency,
)
from gnn_recsys_tpu_torch.retrieval.recs import (
    get_recs,
    head_layer1,
    make_mlp_score_fn,
    model_score_fn,
)
from gnn_recsys_tpu_torch.retrieval.sharded import (
    catalog_axis,
    get_recs_sharded,
    infer_embeddings_sharded,
    merge_candidates,
    shard_catalog,
)
from gnn_recsys_tpu_torch.train.checkpoint import load_run, model_kwargs_to_config, save_run
from gnn_recsys_tpu_torch.train.full_batch import (
    FullBatchConfig,
    TrainState,
    compute_embeddings,
    full_batch_inputs,
    init_model,
    make_full_batch_step,
    train_full_batch,
)
from gnn_recsys_tpu_torch.train.graph_step import WARMUP_STEPS
from gnn_recsys_tpu_torch.train.minibatch import (
    EdgeStore,
    MinibatchConfig,
    _per_etype_batch_sizes,
    device_edge_store,
    infer_embeddings,
    iter_edge_batches,
    make_epoch_fns,
    make_minibatch_loss,
    make_minibatch_step,
    train_minibatch,
)
from gnn_recsys_tpu_torch.trial import (
    build_model,
    run_trial_on_graph,
    trial_embeddings,
    trial_metrics,
)
from gnn_recsys_tpu_torch.utils import profiling
from gnn_recsys_tpu_torch.utils.synthetic import (
    make_drift_logs,
    make_hard_synthetic_data,
    make_synthetic_data,
)

# H100 SXM published peaks (NVIDIA data sheet): f32 outside the tensor
# cores, and HBM3 bandwidth.
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12  # dense, on the tensor cores
PEAK_BYTES_PER_S = 3.35e12
TOL = 1e-5  # f32 sums in another order than the plain version's product
# dW / db: sums of K*P terms, relative to the largest entry; the gather-mean
# backward's dh: sums of scaled cotangent rows, fused multiply-adds in
# another order than the plain versions' (each kernel's own order is fixed).
GRAD_REL = 1e-5
BF16_RTOL = 2.0**-7  # one bf16 ulp: both sides round the same f32 sums
# The LSTM cell's kernels in bf16: the plain version's roundings, in its
# order; expf and tanhf may still part by an ulp, now and then.
LSTM_BIT_EQUAL = 0.999
# A bf16 step, eager against replayed from one state: the same code, whose
# only gap is the dedup step's backward adding with atomics.  Each gradient
# within BF16_ROUTE_GRAD_REL of its parameter's largest entry: four times the
# largest gap measured on the H100 (0.0075, one bf16 ulp of an entry near the
# largest; PERF.md).  Where |g| exceeds ABOVE_GAP times its parameter's gap,
# the update within UPDATE_REL * lr: a gradient entry moved by d moves Adam's
# update by at most about 2.3 * d / |g| of lr over the first 10 steps.
BF16_ROUTE_GRAD_REL, ABOVE_GAP, UPDATE_REL = 3e-2, 20.0, 0.25
# One step, kernel route against plain route: the CPU tests' tolerances
# (tests/test_torch_minibatch.py).
LOSS_RTOL, STEP_GRAD_RTOL, STEP_GRAD_ATOL = 1e-5, 1e-4, 1e-6
# A full-batch step's gradients relative to each parameter's largest entry,
# about four times the largest gaps measured on the H100 (PERF.md): card
# against the CPU's f32 step within FULL_BATCH_GRAD_REL (0.0068 measured, the
# nn model's first-layer weights, where the CPU's f32 step is as far from an
# f64 step), card against the f64 step within FULL_BATCH_F64_GRAD_REL
# (0.00075 measured, the MLP head's output bias).
FULL_BATCH_GRAD_REL, FULL_BATCH_F64_GRAD_REL = 3e-2, 3e-3
BUYS = ("user", "buys", "item")
MIPS = ("gnn_recsys_tpu_torch/csrc/topk_mips.cu", "gnn_recsys_tpu/ops/pallas/topk_mips.py")
LEAF = ("gnn_recsys_tpu_torch/csrc/leaf_agg.cu", "gnn_recsys_tpu/ops/pallas/leaf_agg.py")
POOL = ("gnn_recsys_tpu_torch/csrc/pool_mask.cu", "gnn_recsys_tpu/ops/pallas/pool_mask.py")
GATHER = ("gnn_recsys_tpu_torch/csrc/gather_mean.cu", "gnn_recsys_tpu/ops/pallas/gather_mean.py")
# The LSTM cell replaces no Pallas kernel: its row names the JAX reducer's
# nn.scan (gnn_recsys_tpu/models/layers.py:79).
LSTM = ("gnn_recsys_tpu_torch/csrc/lstm_cell.cu", "gnn_recsys_tpu/models/layers.py")
# Nor does the MLP head's tower: its rows name the JAX PredictingLayer,
# which XLA runs (gnn_recsys_tpu/models/layers.py:211).
PRED = ("gnn_recsys_tpu_torch/csrc/pred_tower.cu", "gnn_recsys_tpu/models/layers.py")
# Nor mlp_topk: its row names the JAX package's ranking by the head, in XLA
# (gnn_recsys_tpu/retrieval/recs.py:68, make_mlp_score_fn).
MLP_RANK = ("gnn_recsys_tpu_torch/csrc/topk_mips.cu", "gnn_recsys_tpu/retrieval/recs.py")
# mlp_topk's scores against its plain version's: sigmoid values near 0.5,
# whose f32 step is 6e-8, from sums in another order.
MLP_TOL = 1e-6
# The tower's gradients in bf16, by the norm of each difference over the
# plain version's norm: the kernels round dz2 to bf16, the plain version
# dz2 W2, about 2^-9 of each per-pair term (0.0023-0.0044 measured).
PRED_GRAD_NORM = 1e-2
# In f32, on inputs whose pre-activations stay away from zero: each gradient
# within this share of its largest entry (sums of up to 2.6M per-pair terms
# in another order; 5.6e-6 measured).
PRED_F32_GRAD_REL = 1e-4
NO_YARDSTICK = "no one-call PyTorch yardstick computes this function"


def say(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def time_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Mean time a call of ``fn`` in ms between CUDA events around
    back-to-back calls (after warm-up).  Where the host takes longer to
    issue a call than the card to run it, this measures the host."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def profiled_kernels(run, n: int, pad_s: float = 0.0):
    """``run`` ``n`` times under ``torch.profiler``: (host ms a run,
    [(kernel name, launches, device us)]).  One call runs in the profiler's
    warm-up cycle, which it discards: on the H100's host it lost the first
    kernels launched as tracing started.  ``pad_s`` idle seconds open and
    close the active window (``profiler_probe.py``: they keep none of the
    records the profiler loses, :func:`phase_profiler_window`)."""
    from torch.profiler import ProfilerActivity, profile, schedule

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        run()
        torch.cuda.synchronize()
        prof.step()
        time.sleep(pad_s)
        t0 = time.perf_counter()
        for _ in range(n):
            run()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3 / n
        time.sleep(pad_s)
        prof.step()
    kernels = []
    for evt in prof.key_averages():
        # User annotations (the profiler's own step, the optimizer's step)
        # carry device time too: the span of the kernels inside them.
        annotation = getattr(evt, "is_user_annotation", False) or evt.key.startswith("ProfilerStep")
        if evt.device_type == torch.autograd.DeviceType.CUDA and not annotation:
            us = getattr(evt, "self_device_time_total", None)
            kernels.append((evt.key, evt.count, evt.self_cuda_time_total if us is None else us))
    return host_ms, kernels


def per_call_ms(kernels, reps: int) -> float:
    """Device ms of one call from a profile of ``reps`` calls: each kernel's
    mean recorded duration times its launches a call.  The profiler on the
    H100's host drops records once the process has run a while (about 10 a
    profile, now and then hundreds: :func:`phase_profiler_window`); the mean
    of the rest still times each launch, and the launches a call are the
    recorded count rounded up to a multiple of ``reps``."""
    return sum(us / count * -(-count // reps) for _, count, us in kernels) / 1e3


def device_ms(fn, reps: int = 20, tries: int = 5) -> float:
    """Device time of one call of ``fn`` in ms (``per_call_ms`` under
    ``torch.profiler``).  A profile with no kernel recorded is taken again;
    after ``tries`` of them this raises, so that ``ms`` always means device
    time.  Take ``reps`` well above the records a profile may lose: 3 calls
    of a two-kernel call (6 records) often kept none late in a run."""
    for _ in range(tries):
        _, kernels = profiled_kernels(fn, reps)
        if kernels:
            return per_call_ms(kernels, reps)
    raise RuntimeError("torch.profiler recorded no CUDA kernel for a call that launches one")


def bound(flops: float, nbytes: float, peak_flops: float = PEAK_F32_FLOPS) -> tuple:
    """(least time in ms, what sets it) on the published H100 peaks (f32
    outside the tensor cores unless ``peak_flops`` says otherwise)."""
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


# ----------------------------------------------------------------------
# Checks
# ----------------------------------------------------------------------

def check_topk(what, vals, idx, rvals, ridx, exact_score, tol=TOL) -> float:
    """Values within ``tol`` of the plain version's; indices equal except at
    near-tied slots, where the kernel's item must score within ``tol`` of
    the slot's plain value.  ``exact_score(rows, items)`` gives f64 scores.
    Returns the largest value difference."""
    err = float((vals - rvals).abs().max()) if vals.numel() else 0.0
    if not err <= tol:
        raise AssertionError(f"{what}: values differ by {err}")
    rows, cols = torch.nonzero(idx != ridx, as_tuple=True)
    if rows.numel():
        gap = (exact_score(rows, idx[rows, cols]) - rvals[rows, cols].double()).abs()
        if not float(gap.max()) <= tol:
            raise AssertionError(f"{what}: {rows.numel()} index mismatches, "
                                 f"largest score gap {float(gap.max())}")
    srt = idx.sort(dim=1).values
    if (srt[:, 1:] == srt[:, :-1]).any():
        raise AssertionError(f"{what}: repeated index in a row")
    return err


def dot_scores(ue, ie):
    ue64, ie64 = ue.double(), ie.double()
    return lambda r, i: (ue64[r] * ie64[i]).sum(dim=-1)


# ----------------------------------------------------------------------
# Phases
# ----------------------------------------------------------------------

def phase_device() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device")
    kind = torch.cuda.get_device_name(0)
    say("device", nvidia_smi=smi(), kind=kind, torch=torch.__version__,
        cuda=torch.version.cuda, count=torch.cuda.device_count())
    return kind


BF16 = "13__nv_bfloat16"  # a template argument __nv_bfloat16, mangled


def _gather_pieces(direction: str, elem: str, vec: int) -> tuple:
    """The gather-mean instantiations of the main paths: K = 8 and 4 on the
    16-byte path (``vec`` elements a load; the dedup step's), and the
    full-fanout gathers' (the search's and the CLI drill's, f32, where D = 2
    takes the scalar path too): the forward at K > 32, the backward's walk
    and reduce, and its prep and scan."""
    pieces = tuple(f"gather_mean_{direction}_kernelI{elem}Li{vec}ELi{k}EE" for k in (8, 4))
    vecs = (vec, 1) if elem == "f" else (vec,)
    if direction == "fwd":
        return pieces + tuple(f"gather_mean_fwd_wide_kernelI{elem}Li{v}EE" for v in vecs)
    return pieces + tuple(f"gather_mean_bwd_{part}_kernelI{elem}Li{v}EE"
                          for part in ("walk", "reduce") for v in vecs) + (
        "gather_mean_bwd_prep_kernel", "gather_mean_bwd_scan_kernel")


# The instantiations each row's main path runs, by a piece of their mangled
# names: the leaf kernels' F = 8 ones (the tree step's), in f32 and bf16; the
# gather-mean kernels' 16-byte paths at K = 8 and 4 (the dedup step's) and
# the full-fanout design's (:func:`_gather_pieces`), in f32 and bf16;
# topk_kernel's f32 ones that serving runs (mips_topk and mips_boost with
# lists of k <= 32 in the shared buffer, the LSE epilogue) and mlp_topk's
# with lists of k <= 32 (an nn run's), the pool mask.
# None may spill.
NO_SPILL = {
    "leaf_mean_nn_fwd": ("leaf_agg", ("leaf_fwd_kernelIfLi8EE",)),
    "leaf_mean_nn_fwd:bf16": ("leaf_agg", (f"leaf_fwd_kernelI{BF16}Li8EE",)),
    "leaf_mean_nn_bwd": ("leaf_agg", ("leaf_bwd_kernelIfLi8EE", "leaf_bwd_reduce_kernel")),
    "leaf_mean_nn_bwd:bf16": ("leaf_agg", (f"leaf_bwd_kernelI{BF16}Li8EE",
                                            "leaf_bwd_reduce_kernel")),
    "gather_mean_fwd": ("gather_mean", _gather_pieces("fwd", "f", 4)),
    "gather_mean_fwd:bf16": ("gather_mean", _gather_pieces("fwd", BF16, 8)),
    "gather_mean_bwd": ("gather_mean", _gather_pieces("bwd", "f", 4)),
    "gather_mean_bwd:bf16": ("gather_mean", _gather_pieces("bwd", BF16, 8)),
    "mips_topk": ("topk_mips", ("topk_kernelIfLb1ELi0EE",)),
    "mips_lse": ("topk_mips", ("topk_kernelIfLb0ELi2EE",)),
    "mips_boost": ("topk_mips", ("topk_kernelIfLb1ELi1EE",)),
    "pool_membership_mask": ("pool_mask", ("pool_mask_kernel",)),
    "mlp_topk": ("topk_mips", ("mlp_topk_kernelILb1EE",)),
    # The tower's bf16 forward, its dW2 pass and the sums; not its dA pass,
    # which spills 80 bytes beside its 64 dA_i and 17 small-gradient sums.
    "pred_tower_fwd:bf16": ("pred_tower", (f"pred_tower_fwd_kernelI{BF16}E",)),
    "pred_tower_bwd:bf16": ("pred_tower", (f"pred_tower_dw2_kernelI{BF16}E",
                                           "pred_tower_sum_kernel")),
}


def kernel_ptxas(info, rows=NO_SPILL) -> dict:
    """Registers and spill bytes of each instantiation that ``rows`` names,
    from ``build.build_info`` (library -> {"ptxas": lines}); raises where
    one spills."""
    out = {}
    for name, (lib, pieces) in rows.items():
        funcs = build.ptxas_summary(info[lib]["ptxas"])
        for piece in pieces:
            hits = [v for k, v in funcs.items() if piece in k]
            if len(hits) != 1:
                raise RuntimeError(f"ptxas summary: {len(hits)} entry functions match {piece}")
            if hits[0]["spill_bytes"]:
                raise AssertionError(f"{piece} spills {hits[0]['spill_bytes']} bytes")
            out.setdefault(name, {})[piece] = hits[0]
    return out


def phase_build() -> dict:
    """Builds every kernel; returns the main path's instantiations' ptxas
    summary by kernels-line row."""
    t0 = time.perf_counter()
    build.build(["topk_mips", "leaf_agg", "pool_mask", "gather_mean", "lstm_cell", "pred_tower"])
    ptxas = kernel_ptxas(build.build_info)
    say("build", seconds=time.perf_counter() - t0, info=build.build_info, ptxas=ptxas)
    return ptxas


def kernel_row(rows, timed, name, files, tpu_line, err, kernel, plain, library, flops, nbytes,
               plain_reps=20, **extra) -> dict:
    """One row of the kernels line, appended to ``rows`` and printed: the
    bound from ``flops`` and ``nbytes`` (at ``extra["peak_flops"]`` where
    given) and, with ``timed``, the device ms of ``kernel``, ``plain`` and
    ``library`` (None: no one-call yardstick).  ``plain_reps``: the profiled
    calls of ``plain`` and ``library``, fewer for calls of thousands of
    launches: 20 profiled calls of ``mlp_topk``'s plain version and library
    held 600,000 kernel records, and the profiler then lost the records of
    the next row's profile."""
    b_ms, b_by = bound(flops, nbytes, extra.pop("peak_flops", PEAK_F32_FLOPS))
    row = {"name": name, "route": "cuda", "source": files[0],
           "replaces": f"{files[1]}:{tpu_line}", "launches": None,
           "max_abs_err": err, "ms": None, "plain_ms": None,
           "bound_ms": b_ms, "bound_by": b_by, "library_ms": None, **extra}
    if library is None:
        row["library"] = NO_YARDSTICK
    if timed:
        with tm.full_f32_matmul():
            # One clock for all three: profiled calls.
            row.update(ms=device_ms(kernel), events_ms=time_ms(kernel),
                       plain_ms=device_ms(plain, reps=plain_reps))
            if library is not None:
                row["library_ms"] = device_ms(library, reps=plain_reps)
    rows.append(row)
    say("kernel", **row)
    return row


def phase_kernels(dev, num_users=4096, num_items=30_000, dim=128, k=26,
                  weight=1.0, leaf=(8, 18_432, 8, 256), pool=(1024, 32, 2560),
                  gather=(38_912, 8, 30_000, 256), wide=(904, 1280, 3000, 256),
                  lstm=((2048, 4608, 8192, 18_432), 256), pred=(1024, 2560),
                  mlp=((20, 42, 266), 300, 100_000), timed=True, seed=0) -> list:
    """Each kernel against its plain version on ``dev``; returns the rows of
    the kernels line (without launches).  ``leaf`` is (K, P, F, H),
    ``pool`` (B, K, P), ``gather`` and ``wide`` (B, K, N, D), ``lstm``
    (the rows N of each cell update's shape, H), ``pred`` (B, P), ``mlp``
    mlp_topk's fetches, the users of its case with catalog splits and those
    of the serving cell's case (:func:`mlp_topk_rows`)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    ue = l2_normalize(torch.randn(num_users, dim, generator=gen, device=dev))
    ie = l2_normalize(torch.randn(num_items, dim, generator=gen, device=dev))
    pop = torch.rand(num_items, generator=gen, device=dev)
    exact = dot_scores(ue, ie)
    rows = []

    def record(*args, **extra):
        return kernel_row(rows, timed, *args, **extra)

    def mips(name, tpu_line, err, kernel, plain, library, flops, nbytes):
        record(name, MIPS, tpu_line, err, kernel, plain, library, flops, nbytes)

    flops = 2.0 * num_users * num_items * dim
    emb_bytes = 4.0 * (num_users + num_items) * dim
    topk_bytes = num_users * k * (4 + 8)

    # mips_topk, f32
    vals, idx = tm.mips_topk(ue, ie, k)
    rvals, ridx = tm.mips_topk_reference(ue, ie, k)
    err = check_topk("mips_topk f32", vals, idx, rvals, ridx, exact)
    # all items tied: exactly the lowest indices
    ie_tied = ie[:1].expand(num_items, dim).contiguous()
    _, tidx = tm.mips_topk(ue, ie_tied, k)
    if not torch.equal(tidx, torch.arange(k, device=dev).expand(num_users, k)):
        raise AssertionError("mips_topk: ties must go to the lowest indices")
    # bf16 inputs
    bvals, bidx = tm.mips_topk(ue, ie, k, bf16=True)
    brvals, bridx = tm.mips_topk_reference(ue, ie, k, bf16=True)
    err_bf16 = check_topk("mips_topk bf16", bvals, bidx, brvals, bridx,
                          dot_scores(ue.bfloat16(), ie.bfloat16()))
    say("kernel_bf16", name="mips_topk", max_abs_err=err_bf16)
    # a width that is not a multiple of 4 (zero-padded by the wrapper), from
    # a generator of its own: the later cases keep their inputs (the leaf
    # backward's check is sensitive to them, ROADMAP.md queue 3)
    gen33 = torch.Generator(device=dev).manual_seed(seed + 33)
    ue33 = l2_normalize(torch.randn(num_users, 33, generator=gen33, device=dev))
    ie33 = l2_normalize(torch.randn(num_items, 33, generator=gen33, device=dev))
    err_d33 = check_topk("mips_topk D=33", *tm.mips_topk(ue33, ie33, k),
                         *tm.mips_topk_reference(ue33, ie33, k), dot_scores(ue33, ie33))
    say("kernel_case", name="mips_topk", case="D=33", max_abs_err=err_d33)
    mips("mips_topk", 52, max(err, err_bf16, err_d33),
           lambda: tm.mips_topk(ue, ie, k), lambda: tm.mips_topk_reference(ue, ie, k),
           lambda: torch.topk(ue @ ie.T, k, dim=1), flops, emb_bytes + topk_bytes)

    # Both boosted passes: pass 1's normaliser (error on the log-sum-exp
    # scale), pass 2's top-k on the plain normaliser; then the cases of
    # mips_topk beside the serving shape, from a generator of their own.
    lse_err, boost_err, (rm, rs) = check_boosted("", ue, ie, pop, k, weight, False)
    _, tidx = tm.mips_topk_boosted(ue, ie_tied, torch.zeros_like(pop), k, weight=weight)
    if not torch.equal(tidx, torch.arange(k, device=dev).expand(num_users, k)):
        raise AssertionError("mips_boost: ties must go to the lowest indices")
    genb = torch.Generator(device=dev).manual_seed(seed + 77)
    k_max = tm.max_k() if dev.type == "cuda" else num_items
    for case, (cu, ci, cd, ck, cbf16) in boosted_cases(num_users, num_items, dim, k,
                                                         k_max).items():
        cue = l2_normalize(torch.randn(cu, cd, generator=genb, device=dev))
        cie = l2_normalize(torch.randn(ci, cd, generator=genb, device=dev))
        cpop = torch.rand(ci, generator=genb, device=dev)
        *errs, (cm, cs) = check_boosted(f" {case}", cue, cie, cpop, ck, weight, cbf16)
        calls = (lambda: tm.mips_lse(cue, cie, bf16=cbf16),
                 lambda: tm.mips_boost(cue, cie, cpop, cm, cs, ck, weight=weight, bf16=cbf16))
        if ck > 32:  # mips_topk's lists in device memory too
            errs.append(check_topk(f"mips_topk {case}", *tm.mips_topk(cue, cie, ck),
                                   *tm.mips_topk_reference(cue, cie, ck), dot_scores(cue, cie)))
            calls += (lambda: tm.mips_topk(cue, cie, ck),)
        for name, e, call in zip(("mips_lse", "mips_boost", "mips_topk"), errs, calls):
            say("kernel_case", name=name, case=case, shape=[cu, ci, cd, ck], max_abs_err=e,
                ms=device_ms(call) if timed else None)
        lse_err, boost_err = max(lse_err, errs[0]), max(boost_err, errs[1])
    mips("mips_lse", 108, lse_err, lambda: tm.mips_lse(ue, ie),
           lambda: tm.mips_lse_reference(ue, ie),
           lambda: torch.logsumexp(ue @ ie.T, dim=1), flops, emb_bytes + 8.0 * num_users)
    mips("mips_boost", 141, boost_err,
           lambda: tm.mips_boost(ue, ie, pop, rm, rs, k, weight=weight),
           lambda: tm.mips_boost_reference(ue, ie, pop, rm, rs, k, weight=weight),
           lambda: torch.topk(torch.softmax(ue @ ie.T, dim=1) + weight * pop, k, dim=1),
           flops, emb_bytes + 4.0 * num_items + 8.0 * num_users + topk_bytes)
    mlp_topk_rows(dev, record, num_users, num_items, *mlp, seed=seed)
    leaf_rows(dev, gen, record, *leaf)
    pool_rows(dev, gen, record, *pool)
    gather_rows(dev, gen, record, *gather)
    wide_gather_rows(dev, record, *wide)
    lstm_cell_rows(dev, record, *lstm, timed=timed)
    pred_tower_rows(dev, record, *pred, timed=timed)
    return rows


def mlp_case(dev, num_users, num_items, seed) -> tuple:
    """A head at a trained head's scales beside user and item embeddings of
    width 128: (its score function, the embeddings ue and ie, mlp_topk's
    inputs: layer 1's halves a_u (its bias in them) and a_i, then w2, b2, w3
    and b3)."""
    gen = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape, scale):
        return scale * torch.randn(*shape, generator=gen, device=dev)

    h1, h2 = tm.MLP_H1, tm.MLP_H2
    fn = make_mlp_score_fn({
        "pred_layer.hidden_1.weight": randn(h1, 2 * 128, scale=0.044),
        "pred_layer.hidden_1.bias": randn(h1, scale=0.1),
        "pred_layer.hidden_2.weight": randn(h2, h1, scale=0.1),
        "pred_layer.hidden_2.bias": randn(h2, scale=0.1),
        "pred_layer.output.weight": randn(1, h2, scale=0.3),
        "pred_layer.output.bias": randn(1, scale=0.1)})
    ue, ie = randn(num_users, 128, scale=1.0), randn(num_items, 128, scale=1.0)
    w1, b1, *head = fn.head(dev)
    with tm.full_f32_matmul():
        halves = head_layer1(w1, b1, ue, ie)
    return fn, ue, ie, [*halves, *head]


def mlp_exact(args):
    """The head's f64 score of pairs (rows r, items i) from mlp_topk's inputs."""
    a_u, a_i, w2, b2, w3, b3 = (t.double() for t in args)

    def score(r, i):
        z = torch.relu(torch.relu(a_u[r] + a_i[i]) @ w2.T + b2)
        return torch.sigmoid(z @ w3.reshape(-1) + b3)
    return score


def mlp_topk_rows(dev, record, num_users, num_items, fetches, split_users, serve_users,
                  seed=0) -> None:
    """``mlp_topk`` against its plain version (the tile loop and a stable
    sort) at U x I and each of ``fetches``; at the first fetch with
    ``split_users`` users (a few user blocks, so catalog splits) and with
    ``serve_users`` users (the serving cell's shape at 100,000: one user
    block per 128 users, no split), each case's splits reported; then a row
    at the first fetch (the serving cell's: k 10 and 10 bought items a user)
    at U x I, whose library is the route the head ranked by before the
    kernel: ``get_recs``'s torch route, a chunk of 128 users at a time
    through both halves of layer 1, the tiles and a stable sort.  The bound
    is layers 2 and 3's 8,256 operations a pair at 67 TFLOP/s (layer 1's two
    products are cuBLAS's, outside the kernel)."""
    fn, ue, ie, args = mlp_case(dev, num_users, num_items, seed + 28)
    errs = []

    def case(name, case_args, k):
        errs.append(check_topk(f"mlp_topk {name}", *tm.mlp_topk(*case_args, k),
                               *tm.mlp_topk_reference(*case_args, k), mlp_exact(case_args),
                               tol=MLP_TOL))
        users = case_args[0].shape[0]
        say("kernel_case", name="mlp_topk", case=name, shape=[users, num_items, k],
            max_abs_err=errs[-1], splits=tm._lib().mlp_topk_splits(users, num_items, k)
            if dev.type == "cuda" else None)

    for k in fetches:
        case(f"k={min(k, num_items)}", args, min(k, num_items))
    k = min(fetches[0], num_items)
    case("splits", mlp_case(dev, split_users, num_items, seed + 29)[3], k)
    case("serve", mlp_case(dev, serve_users, num_items, seed + 30)[3], k)
    tied = [args[0][:256], args[1][:1].expand(num_items, tm.MLP_H1), *args[2:]]
    _, tidx = tm.mlp_topk(*tied, k)
    if not torch.equal(tidx, torch.arange(k, device=dev).expand(tidx.shape[0], k)):
        raise AssertionError("mlp_topk: ties must go to the lowest indices")
    uids = torch.arange(num_users, device=dev)
    record("mlp_topk", MLP_RANK, 68, max(errs), lambda: tm.mlp_topk(*args, k),
           lambda: tm.mlp_topk_reference(*args, k),
           lambda: get_recs(ue, ie, uids, k, score_fn=fn, backend="torch"),
           float(num_users) * num_items * 2.0 * (tm.MLP_H1 * tm.MLP_H2 + tm.MLP_H2),
           4.0 * (num_users + num_items) * tm.MLP_H1 + 12.0 * num_users * k,
           plain_reps=2)


def boosted_cases(num_users, num_items, dim, k, k_max) -> dict:
    """The boosted passes' cases beside the serving shape, name -> (users,
    items, dim, k, bf16): bf16; a width zero-padded to 36; k above 32 (the
    partial lists in device memory) at a user count that is not a multiple
    of 128; k = ``k_max``; a catalog of fewer than 16 items (threads with no
    item); k=266, the widest fetch serving makes (k=10 and a user with 256
    bought items)."""
    return {"bf16": (num_users, num_items, dim, k, True),
            "D=33": (num_users, num_items, 33, k, False),
            "k=100": (num_users - 3, num_items, dim, min(100, num_items), False),
            "k=max_k": (min(num_users, 300), min(num_items, 5000), dim,
                        min(k_max, num_items, 5000), False),
            "I=11": (min(num_users, 130), 11, dim, min(k, 5), False),
            "k=266": (num_users, num_items, dim, min(266, num_items), False)}


def check_boosted(what, ue, ie, pop, k, weight, bf16) -> tuple:
    """``mips_lse`` against its plain version on the log-sum-exp scale, and
    ``mips_boost`` on the plain normaliser with ``check_topk``: (lse error,
    boost error, the plain (m, s))."""
    m, s = tm.mips_lse(ue, ie, bf16=bf16)
    rm, rs = tm.mips_lse_reference(ue, ie, bf16=bf16)
    lse_err = float(((m.double() + s.double().log()) -
                     (rm.double() + rs.double().log())).abs().max())
    if not lse_err <= TOL:
        raise AssertionError(f"mips_lse{what}: log-sum-exp differs by {lse_err}")
    vals, idx = tm.mips_boost(ue, ie, pop, rm, rs, k, weight=weight, bf16=bf16)
    rvals, ridx = tm.mips_boost_reference(ue, ie, pop, rm, rs, k, weight=weight, bf16=bf16)
    exact = dot_scores(ue.bfloat16(), ie.bfloat16()) if bf16 else dot_scores(ue, ie)
    m64, s64, p64 = rm.double(), rs.double(), pop.double()
    boost_err = check_topk(
        f"mips_boost{what}", vals, idx, rvals, ridx,
        lambda r, i: torch.exp(exact(r, i) - m64[r]) / s64[r] + weight * p64[i])
    return lse_err, boost_err, (rm, rs)


def leaf_case(dev, gen, k, p, f, h, dtype=torch.float32):
    """Random leaf inputs: x [K, P, F], mask_scaled [P, K] with an all-masked
    row, w [F, H], b [H], and a cotangent g [P, H]."""
    x = torch.randn(k, p, f, generator=gen, device=dev)
    mask = (torch.rand(p, k, generator=gen, device=dev) < 0.7).float()
    mask[p // 2] = 0.0
    ms = mask / mask.sum(dim=1, keepdim=True).clamp(min=1.0)
    w = 0.3 * torch.randn(f, h, generator=gen, device=dev)
    b = 0.1 * torch.randn(h, generator=gen, device=dev)
    g = torch.randn(p, h, generator=gen, device=dev)
    return x.to(dtype), ms, w.to(dtype), b.to(dtype), g.to(dtype)


def check_leaf_bwd(what, x, ms, w, b, g) -> float:
    """The backward kernel's (dW, db) against its plain version, beyond
    ``GRAD_REL`` only by ``leaf_bwd_slack``'s terms, and against a second
    call (same bits); returns the largest difference."""
    dw, db = la.leaf_mean_nn_bwd(x, ms, w, b, g)
    err = 0.0
    for got, want, slack in zip((dw, db), la.leaf_mean_nn_bwd_reference(x, ms, w, b, g),
                                leaf_bwd_slack(x, ms, w, b, g)):
        diff = (got - want).abs()
        err = max(err, float(diff.max()))
        excess = float((diff.double() - slack).max())
        if not excess <= GRAD_REL * max(1.0, float(want.abs().max())):
            raise AssertionError(f"{what}: differs by {float(diff.max())}, "
                                 f"{excess} beyond its near-zero pre-activations' terms")
    dw2, db2 = la.leaf_mean_nn_bwd(x, ms, w, b, g)
    if not (torch.equal(dw, dw2) and torch.equal(db, db2)):
        raise AssertionError(f"{what}: two runs differ")
    return err


def leaf_rows(dev, gen, record, k, p, f, h) -> None:
    """``leaf_mean_nn`` forward and backward against their plain versions,
    in f32 (inputs from ``gen``) and then in bf16 (x, W, b and the cotangent
    bf16, the mask f32: the tree step's dtypes at the bench config; inputs
    from a generator of their own, so that the cases after keep theirs): at
    the shape given and a ragged P, the forward within ``TOL`` (in bf16
    ``BF16_RTOL`` of each entry) with the all-masked row 0, the backward as
    :func:`check_leaf_bwd` holds it (the kernel widens bf16 to f32 before any
    arithmetic); then each dtype's rows.  The operations are f32 ones (on the
    CUDA cores); in bf16 the bytes are bf16 but for the f32 mask, dW and db."""
    for dtype, dgen, tag in ((torch.float32, gen, ""), (
            torch.bfloat16, torch.Generator(device=dev).manual_seed(16), ":bf16")):
        errs, grad_errs = [], []
        for pp in (p, p - 5 if p > 5 else p):
            x, ms, w, b, g = leaf_case(dev, dgen, k, pp, f, h, dtype)
            out = la.leaf_mean_nn_fwd(x, ms, w, b).float()
            ref = la.leaf_mean_nn_reference(x, ms, w, b).float()
            diff = (out - ref).abs()
            errs.append(float(diff.max()))
            if not (diff <= (BF16_RTOL * ref.abs() + 1e-6 if tag else TOL)).all() or out[
                    pp // 2].any():
                raise AssertionError(f"leaf_mean_nn_fwd{tag} P={pp}: differs by {errs[-1]} "
                                     f"or the all-masked row is not 0")
            grad_errs.append(check_leaf_bwd(f"leaf_mean_nn_bwd{tag} P={pp}", x, ms, w, b, g))

        x, ms, w, b, g = leaf_case(dev, dgen, k, p, f, h, dtype)
        e = x.element_size()
        io = e * (k * p * f + f * h + h) + 4.0 * p * k  # x, w, b; the f32 mask
        record(f"leaf_mean_nn_fwd{tag}", LEAF, 78, max(errs),
               lambda: la.leaf_mean_nn_fwd(x, ms, w, b),
               lambda: la.leaf_mean_nn_reference(x, ms, w, b), None,
               float(k * p * h * (2 * f + 4)), io + e * p * h)
        row = record(f"leaf_mean_nn_bwd{tag}", LEAF, 94, max(grad_errs),
                     lambda: la.leaf_mean_nn_bwd(x, ms, w, b, g),
                     lambda: la.leaf_mean_nn_bwd_reference(x, ms, w, b, g), None,
                     float(k * p * h * (4 * f + 4)), io + e * p * h + 4.0 * (f * h + h))
        if not tag and row["ms"] is not None:
            # The backward's two kernels apart: device ms a call of each.
            reps = 20
            _, kernels = profiled_kernels(lambda: la.leaf_mean_nn_bwd(x, ms, w, b, g), reps)
            split = {part: per_call_ms([k for k in kernels if pat in k[0]], reps)
                     for part, pat in (("main_ms", "leaf_bwd_kernel"),
                                       ("reduce_ms", "leaf_bwd_reduce_kernel"))}
            if not all(split.values()):
                raise RuntimeError(f"leaf_mean_nn_bwd: the profiler missed a kernel: {split}")
            row.update(split)
            say("kernel_split", name="leaf_mean_nn_bwd", **split)


def leaf_bwd_slack(x, ms, w, b, g) -> tuple:
    """Per entry of the leaf backward's (dW [F, H], db [H]): the summed
    |contribution| of the terms whose pre-activation z lies within f32
    rounding of 0, where the ReLU derivative may differ between the kernel's
    summation order and the plain version's.  z is taken in f64; a term is
    near zero where |z| <= (F + 1) * 2**-23 * (sum_f |x w| + |b|), twice the
    worst-case rounding of an f32 dot of F + 1 terms.  Only these terms may
    add to the difference beyond ``GRAD_REL``.  The window is f32's for bf16
    inputs too: both sides widen them to f32 before any arithmetic, so z is
    an f32 dot of exact values either way."""
    x64, w64, b64 = x.double(), w.double(), b.double()
    z = torch.einsum("kpf,fh->kph", x64, w64) + b64
    scale = torch.einsum("kpf,fh->kph", x64.abs(), w64.abs()) + b64.abs()
    near = z.abs() <= (w.shape[0] + 1) * 2.0**-23 * scale
    del z, scale
    terms = (g.double()[None] * ms.double().T[:, :, None]).abs() * near  # [K, P, H]
    return torch.einsum("kpf,kph->fh", x64.abs(), terms), terms.sum(dim=(0, 1))


def pool_case(dev, gen, b, k, p, ids=30_000):
    """Rows [B, K] of ids below ``ids``, -1 padded; a pool [P] whose first
    entries are row 0's (some pairs hit; -1 never matches)."""
    rows = torch.randint(0, ids, (b, k), generator=gen, device=dev, dtype=torch.int32)
    valid = torch.randint(0, k + 1, (b, 1), generator=gen, device=dev)
    rows[torch.arange(k, device=dev)[None, :] >= valid] = -1
    pool = torch.randint(0, ids, (p,), generator=gen, device=dev, dtype=torch.int32)
    pool[: min(p, k)] = rows[0, : min(p, k)]
    return rows, pool


def pool_rows(dev, gen, record, b, k, p) -> None:
    """``pool_membership_mask`` against its plain version, bit for bit: -1
    padded rows at the shape given, ragged (B, P), P = p - 3 (2557: a tail
    that is not a whole 16-byte store), K = 128, and ids from 300 values (pool
    entries and row slots repeat) with negative pool entries."""
    cases = {"shape": (b, k, p), "ragged": (max(1, b - 24), k, max(1, p - 60)),
             "P-3": (b, k, max(1, p - 3)), "K=128": (b, 128, p), "repeats": (b, k, p)}
    for name, (bb, kk, pp) in cases.items():
        rows, pool = pool_case(dev, gen, bb, kk, pp, 300 if name == "repeats" else 30_000)
        if name == "repeats":
            pool[::5] = -1 - pool[::5]
        out = pm.pool_membership_mask(rows, pool)
        if not torch.equal(out, pm.pool_membership_mask_reference(rows, pool)):
            raise AssertionError(f"pool_membership_mask {name} [{bb}, {kk}, {pp}] differs")
    rows, pool = pool_case(dev, gen, b, k, p)
    # Compares the function needs: every valid slot of a row, per pool entry.
    compares = float(p) * float((rows >= 0).sum())
    record("pool_membership_mask", POOL, 31, 0.0, lambda: pm.pool_membership_mask(rows, pool),
           lambda: pm.pool_membership_mask_reference(rows, pool), None,
           compares, 4.0 * (b * k + p + b * p))


def gather_case(dev, gen, b, k, n, d, dtype=torch.float32):
    """Random gather-mean inputs: h [N, D], int32 ids [B, K] with -1 and >= N
    among the valid slots (both clipped), a bool mask with an all-masked row,
    and a cotangent [B, D]; h and the cotangent in ``dtype``."""
    h = torch.randn(n, d, generator=gen, device=dev)
    nbr = torch.randint(0, n, (b, k), generator=gen, device=dev, dtype=torch.int32)
    mask = torch.rand(b, k, generator=gen, device=dev) < 0.8
    mask[b // 2] = False
    nbr[0, 0], nbr[-1, -1] = -1, n + 3
    mask[0, 0] = mask[-1, -1] = True
    return h.to(dtype), nbr, mask, torch.randn(b, d, generator=gen, device=dev).to(dtype)


def check_gather_fwd(what, h, nbr, mask) -> float:
    """The forward kernel against its plain version, relative to the largest
    entry (``TOL``: f32 sums in another order; in bf16 ``BF16_RTOL``, both
    round the same f32 sums), with the all-masked rows 0; returns the
    difference."""
    out, want = gm.gather_mean_fwd(h, nbr, mask), gm.gather_mean_reference(h, nbr, mask)
    err = float((out.float() - want.float()).abs().max())
    tol = BF16_RTOL if h.dtype == torch.bfloat16 else TOL
    if not err <= tol * max(1.0, float(want.float().abs().max())):
        raise AssertionError(f"{what}: differs by {err}")
    if out[~mask.any(dim=1)].any():
        raise AssertionError(f"{what}: an all-masked row is not 0")
    return err


def gather_rows(dev, gen, record, b, k, n, d) -> None:
    """``gather_mean`` forward and backward against their plain versions,
    in f32 (inputs from ``gen``) and then in bf16 (the dedup step's dtype at
    the bench config; inputs from a generator of their own), at the shape
    given and a ragged B; then each dtype's rows.  The one-call yardstick is
    ``embedding_bag`` in the table's dtype (sum, per-slot weights m /
    max(count, 1)), forward and its autograd backward."""
    for dtype, dgen, tag in ((torch.float32, gen, ""), (
            torch.bfloat16, torch.Generator(device=dev).manual_seed(17), ":bf16")):
        errs, grad_errs = [], []
        for bb in (b, b - 7 if b > 7 else b):
            h, nbr, mask, g = gather_case(dev, dgen, bb, k, n, d, dtype)
            errs.append(check_gather_fwd(f"gather_mean_fwd{tag} B={bb}", h, nbr, mask))
            tr = gm.slot_transpose(nbr, mask, n)
            grad_errs.append(check_gather_bwd(f"gather_mean_bwd{tag} B={bb}", gm.gather_mean_bwd(
                g, nbr, mask, n), g, nbr, mask, n, tr))

        h, nbr, mask, g = gather_case(dev, dgen, b, k, n, d, dtype)
        tr = gm.slot_transpose(nbr, mask, n)
        bag, bag_bwd = embedding_bag_calls(h, nbr, mask, g)
        fwd_cost, bwd_cost = gather_costs(b, k, n, d, nbr, mask, h.element_size())
        dt = "bf16 " if tag else ""
        note = (f"{dt}uniform random ids (no step has them); launches: every shape of the "
                f"{dt}dedup step")
        fwd = record(f"gather_mean_fwd{tag}", GATHER, 49, max(errs),
                     lambda: gm.gather_mean_fwd(h, nbr, mask),
                     lambda: gm.gather_mean_reference(h, nbr, mask), bag, *fwd_cost,
                     shape=note)
        if not tag and fwd["ms"] is not None:
            fwd["l2_resident_ms"] = l2_resident_fwd_ms(h, nbr, mask)
        row = record(f"gather_mean_bwd{tag}", GATHER, 49, max(grad_errs),
                     lambda: gm.gather_mean_bwd(g, nbr, mask, n, tr),
                     lambda: gm.gather_mean_bwd_plain(g, mask, n, tr), bag_bwd, *bwd_cost,
                     shape=note)
        if not tag and row["ms"] is not None:
            # A caller without a plan: the wrapper's own sort of the ids, then the kernel.
            row["without_plan_ms"] = device_ms(lambda: gm.gather_mean_bwd(g, nbr, mask, n))


def skewed_gather_case(dev, gen, b, k, n, d, valid=0.08) -> tuple:
    """A full-fanout gather as the dedup'd plan makes one at the CLI drill's
    user tables: ``valid`` of the slots valid (the drill's 92,706 of 1.16M at
    K = 1,280), their ids from a power law over rows 1..N-1 (1 + floor((n-1)
    u^2): row 1 takes about n^-1/2 of them), every masked slot on row 0 (the
    plan's row for the padding id, which no valid slot reads), f32 h [N, D]
    and cotangent [B, D], and the plan's kind of transpose, which lists every
    slot, masked ones included."""
    u = torch.rand(b, k, generator=gen, device=dev)
    mask = torch.rand(b, k, generator=gen, device=dev) < valid
    nbr = torch.where(mask, 1 + ((n - 1) * u * u).to(torch.int32), 0)
    h = torch.randn(n, d, generator=gen, device=dev)
    g = torch.randn(b, d, generator=gen, device=dev)
    srt, order = torch.sort(nbr.long().reshape(-1), stable=True)
    start = torch.searchsorted(srt, torch.arange(n + 1, device=dev))
    return h, nbr, mask, g, gm.SlotTranspose(order.to(torch.int32), start.to(torch.int32))


def wide_gather_rows(dev, record, b, k, n, d) -> None:
    """Both gather-mean kernels at a full-fanout shape on
    :func:`skewed_gather_case` ids (:func:`gather_check_rows`), in f32 and
    then bf16 (rows ``gather_mean_*:wide:B…_K…_N…_D…`` and
    ``gather_mean_*:bf16:wide:…``), with the slot and run statistics; the
    backward through the plan's kind of transpose, and also timed with the
    wrapper's own sort (``without_plan_ms``)."""
    gen = torch.Generator(device=dev).manual_seed(29)
    h, nbr, mask, g, tr = skewed_gather_case(dev, gen, b, k, n, d)
    label = "wide:B{}_K{}_N{}_D{}".format(b, k, n, d)
    stats = {**slot_stats(nbr, mask, n, b), **run_stats(tr, n, b, k)}
    say("gather_wide_case", label=label, **stats)
    for tag, hh, gg in (("", h, g), ("bf16:", h.bfloat16(), g.bfloat16())):
        _, row = gather_check_rows(record, f"{tag}{label}", hh, gg, nbr, mask, n, tr, stats)
        if row["ms"] is not None:
            row["without_plan_ms"] = device_ms(lambda gg=gg: gm.gather_mean_bwd(gg, nbr, mask, n))


def gather_check_rows(record, what, h, g, nbr, mask, n, tr, stats) -> tuple:
    """Both gather-mean kernels on one input (table ``h``, cotangent ``g``,
    transpose ``tr``) against their plain versions, recorded as rows
    ``gather_mean_fwd:<what>`` and ``gather_mean_bwd:<what>`` beside the
    bound, the plain versions and ``embedding_bag``; returns both rows."""
    (b, k), d = nbr.shape, h.shape[1]
    err = check_gather_fwd(f"gather_mean_fwd {what}", h, nbr, mask)
    grad_err = check_gather_bwd(f"gather_mean_bwd {what}", gm.gather_mean_bwd(g, nbr, mask, n, tr),
                                g, nbr, mask, n, tr)
    bag, bag_bwd = embedding_bag_calls(h, nbr, mask, g)
    fwd_cost, bwd_cost = gather_costs(b, k, n, d, nbr, mask, h.element_size())
    fwd = record(f"gather_mean_fwd:{what}", GATHER, 49, err,
                 lambda: gm.gather_mean_fwd(h, nbr, mask),
                 lambda: gm.gather_mean_reference(h, nbr, mask), bag, *fwd_cost, shape=stats)
    bwd = record(f"gather_mean_bwd:{what}", GATHER, 49, grad_err,
                 lambda: gm.gather_mean_bwd(g, nbr, mask, n, tr),
                 lambda: gm.gather_mean_bwd_plain(g, mask, n, tr), bag_bwd, *bwd_cost,
                 shape=stats)
    return fwd, bwd


def gather_costs(b, k, n, d, nbr, mask, elem=4) -> tuple:
    """((flops, bytes) of the forward, (flops, bytes) of the backward) of a
    [B, K] gather into an [N, D] table of ``elem``-byte elements: each input
    read once and each output written once.  The forward reads the table
    rows its valid slots name (at uniform ids all N; at the step's, fewer),
    the int32 ids, the bool mask, and writes out; the backward reads dout,
    the ids and the mask and writes every row of dh."""
    ids = nbr[mask].long().clamp(0, n - 1)
    valid, named = float(ids.numel()), float(torch.unique(ids).numel())
    io = 4.0 * b * k + b * k
    return ((valid * d + b * d, io + elem * (named * d + b * d)),
            (2.0 * valid * d + b * d, io + elem * (b * d + n * d)))


def embedding_bag_calls(h, nbr, mask, g) -> tuple:
    """The one-call yardstick of each gather-mean kernel: ``embedding_bag``
    (sum, per-slot weights m / max(count, 1), in ``h``'s dtype) and its
    autograd backward."""
    m = mask.float()
    weights = (m / m.sum(dim=1, keepdim=True).clamp(min=1.0)).to(h.dtype)
    clipped = nbr.long().clamp(0, h.shape[0] - 1)
    h_req = h.clone().requires_grad_()
    bag = torch.nn.functional.embedding_bag(clipped, h_req, mode="sum",
                                            per_sample_weights=weights)
    return (lambda: torch.nn.functional.embedding_bag(clipped, h, mode="sum",
                                                      per_sample_weights=weights),
            lambda: torch.autograd.grad(bag, h_req, g, retain_graph=True))


def plain_gather_mean(h, nbr, mask, transpose=None):
    """The block forward's plain route: the forward's plain version, which
    autograd differentiates (the transpose is not used)."""
    return gm.gather_mean_reference(h, nbr, mask)


def lstm_cell_case(dev, n, h, dtype, seed):
    """Random inputs of one cell update as the reducer makes them: the two
    products and the bias in ``dtype``, a carry (c, h) with h in (-1, 1),
    a mask with about 10% holes, and the cotangents of c' and h'."""
    gen = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape, scale=1.0):
        return (scale * torch.randn(*shape, generator=gen, device=dev)).to(dtype)

    xw, hw, bias = randn(n, 4 * h, scale=1.5), randn(n, 4 * h), randn(4 * h, scale=0.3)
    c = randn(n, h, scale=1.5)
    hh = torch.tanh(torch.randn(n, h, generator=gen, device=dev)).to(dtype)
    mask = torch.rand(n, generator=gen, device=dev) > 0.1
    return xw, hw, bias, c, hh, mask, randn(n, h), randn(n, h)


def check_cell(what, pairs) -> tuple:
    """Each (kernel, plain) output pair of an LSTM cell kernel: the same
    dtype and shape; bf16 within one ulp on every element and the same bits
    on ``LSTM_BIT_EQUAL`` of them or more; f32 within ``TOL``.  Returns (the
    largest difference, the share of equal elements)."""
    err, same, total, bf16 = 0.0, 0, 0, False
    for got, want in pairs:
        if got.dtype != want.dtype or got.shape != want.shape:
            raise AssertionError(f"{what}: {got.dtype} {tuple(got.shape)} against "
                                 f"{want.dtype} {tuple(want.shape)}")
        if not got.numel():
            continue
        err = max(err, float((got.float() - want.float()).abs().max()))
        same, total = same + int((got == want).sum()), total + got.numel()
        if got.dtype == torch.bfloat16:
            bf16 = True
            ulps = (got.view(torch.int16).int() - want.view(torch.int16).int()).abs()
            far = int(((got != want) & (ulps > 1)).sum())
            if far:
                raise AssertionError(f"{what}: {far} elements more than one bf16 ulp apart")
        elif not err <= TOL:
            raise AssertionError(f"{what}: differs by {err}")
    share = same / max(total, 1)
    if bf16 and not share >= LSTM_BIT_EQUAL:
        raise AssertionError(f"{what}: only {share} of the elements are the same bits")
    return err, share


def lstm_cell_rows(dev, record, ns, h, timed=True) -> None:
    """The LSTM cell update's kernels against their plain versions
    (:func:`check_cell`): in f32 (``lstm_edge``'s cell) at the largest of
    ``ns`` rows, then in bf16 (the bench LSTM's gates and carry) at each of
    ``ns`` (the bf16 step's 112 cell updates: 24 at N = 2,048 and at 4,608,
    32 at 8,192 and at 18,432), a ``kernel_case`` line each (the kernel's
    device ms with ``timed``).  The forward saves its activations, as
    training does; it is held on c', h' and, on the valid rows, the
    activations, and the backward on dz, dc and dh from those activations.
    Then each dtype's rows at the largest N (``lstm_cell_*`` and
    ``lstm_cell_*:bf16``).  The yardstick is PyTorch's fused LSTM cell
    (``_thnn_fused_lstm_cell`` and its backward, one call each, on CUDA
    only): no mask and one rounding, so not the same function.  The bound is
    the least bytes at 3.35 TB/s, 8 H elements a row forward and 13 H
    backward (``portbench/counts/lstm_cell.py``)."""
    big = max(ns)
    for dtype, tag, sizes in ((torch.float32, "", (big,)),
                              (torch.bfloat16, ":bf16", tuple(sorted(ns)))):
        errs = {"lstm_cell_fwd": (0.0, 1.0), "lstm_cell_bwd": (0.0, 1.0)}
        for n in sizes:
            xw, hw, bias, c, hh, mask, dh, dc = lstm_cell_case(dev, n, h, dtype, seed=n)
            c_new, h_new, acts = lc.lstm_cell_fwd(xw, hw, bias, c, hh, mask)
            want = lc.lstm_cell_fwd_reference(xw, hw, bias, c, hh, mask)
            checks = {
                "lstm_cell_fwd": check_cell(f"lstm_cell_fwd{tag} N={n}", (
                    (c_new, want[0]), (h_new, want[1]), (acts[mask], want[2][mask]))),
                "lstm_cell_bwd": check_cell(f"lstm_cell_bwd{tag} N={n}", tuple(zip(
                    lc.lstm_cell_bwd(acts, c, c_new, mask, dh, dc),
                    lc.lstm_cell_bwd_reference(acts, c, c_new, mask, dh, dc))))}
            calls = {"lstm_cell_fwd": lambda: lc.lstm_cell_fwd(xw, hw, bias, c, hh, mask),
                     "lstm_cell_bwd": lambda: lc.lstm_cell_bwd(acts, c, c_new, mask, dh, dc)}
            for name, (err, share) in checks.items():
                errs[name] = (max(errs[name][0], err), min(errs[name][1], share))
                say("kernel_case", name=name + tag, case=f"N={n}", shape=[n, h],
                    max_abs_err=err, bit_equal_share=share,
                    ms=device_ms(calls[name]) if timed else None)
        # The last case is the largest N: the rows time it.
        fused, zero = torch.ops.aten._thnn_fused_lstm_cell, torch.zeros_like(bias)
        elem = c.element_size()
        cy = work = None
        if timed:
            _, cy, work = fused(xw, hw, c, zero, bias)
        record(f"lstm_cell_fwd{tag}", LSTM, 79, errs["lstm_cell_fwd"][0], calls["lstm_cell_fwd"],
               lambda: lc.lstm_cell_fwd_reference(xw, hw, bias, c, hh, mask),
               lambda: fused(xw, hw, c, zero, bias), 0.0, 8.0 * big * h * elem,
               bit_equal_share=errs["lstm_cell_fwd"][1])
        record(f"lstm_cell_bwd{tag}", LSTM, 79, errs["lstm_cell_bwd"][0], calls["lstm_cell_bwd"],
               lambda: lc.lstm_cell_bwd_reference(acts, c, c_new, mask, dh, dc),
               lambda: torch.ops.aten._thnn_fused_lstm_cell_backward_impl(dh, dc, c, cy, work,
                                                                          True),
               0.0, 13.0 * big * h * elem, bit_equal_share=errs["lstm_cell_bwd"][1])


def pred_tower_case(dev, b, p, dtype, margin=False, seed=0):
    """The tower's inputs at the scales of a trained head: a_u [b, 128] and
    a_i [p, 128] f32, its parameters in ``dtype``, all leaves that take a
    gradient, and the scores' gradient.  With ``margin``, small products
    under biases of +-0.5 and b2 set against layer 2's product at relu(b1),
    so that no pre-activation of layers 1 and 2 comes near zero."""
    gen = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape, scale=1.0):
        return scale * torch.randn(*shape, generator=gen, device=dev)

    scale = 0.02 if margin else 0.7
    a_u, a_i = randn(b, pt.H1, scale=scale), randn(p, pt.H1, scale=scale)
    b1, w2 = randn(pt.H1, scale=0.3), randn(pt.H2, pt.H1, scale=0.17)
    b2, w3, b3 = randn(pt.H2, scale=0.3), randn(pt.H2, scale=0.4), randn(1, scale=0.3)
    if margin:
        b1 = 0.5 * b1.sign()
        b2 = 0.5 * b2.sign() - w2.to(dtype).float() @ torch.relu(b1)
    params = [t.to(dtype) for t in (b1, w2, b2, w3, b3)]
    return [t.requires_grad_() for t in (a_u, a_i, *params)], randn(b, p)


def check_tower(what, args, ds, norm_tol) -> tuple:
    """The tower's kernels against its plain version: the scores within
    ``TOL``; each gradient within ``norm_tol`` of its tensor's norm, by the
    norm of the difference (None: within ``PRED_F32_GRAD_REL`` of its
    largest entry, for inputs with a margin), and the same bits from a
    second backward.
    Returns (the scores' largest gap, the gradients' largest gap, the
    forward's scores)."""
    s = pt.pred_tower_fwd(*args)
    fwd_err = float((s - pt.pred_tower_reference(*args).detach()).abs().max())
    if not fwd_err <= TOL:
        raise AssertionError(f"{what}: scores differ by {fwd_err}")
    got = pt.pred_tower_bwd(ds, s, *args)
    bwd_err = 0.0
    for g, want, x in zip(got, pt.pred_tower_bwd_reference(ds, *args), args):
        if g.dtype != x.dtype or g.shape != x.shape:
            raise AssertionError(f"{what}: a gradient of {g.dtype} {tuple(g.shape)}")
        d, w = (g.double() - want.double()), want.double()
        gap = float(d.norm() / w.norm().clamp_min(1e-300)) if norm_tol is not None \
            else float(d.abs().max() / w.abs().max().clamp_min(1e-300))
        bwd_err = max(bwd_err, gap)
    if not bwd_err <= (norm_tol if norm_tol is not None else PRED_F32_GRAD_REL):
        raise AssertionError(f"{what}: gradients differ by {bwd_err}")
    if not all(torch.equal(a, b) for a, b in zip(got, pt.pred_tower_bwd(ds, s, *args))):
        raise AssertionError(f"{what}: two backward calls differ")
    return fwd_err, bwd_err, s


def concat_head_case(dev, b, p, dtype) -> tuple:
    """The head the port ran before the tower: the unfactorised
    ``PredictingLayer`` in ``dtype`` on the [B, P, 256] broadcast concat of
    B and P embedding rows (128 wide).  Returns its forward (the scores [B,
    P]) and the leaves its backward reaches."""
    head = PredictingLayer(2 * 128, dtype=dtype).to(dev)
    gen = torch.Generator(device=dev).manual_seed(b + p)
    u = torch.randn(b, 128, generator=gen, device=dev).to(dtype).requires_grad_()
    items = torch.randn(p, 128, generator=gen, device=dev).to(dtype).requires_grad_()

    def concat_head():
        return head(torch.cat(torch.broadcast_tensors(u[:, None], items[None]), -1))[..., 0]

    return concat_head, [u, items, *head.parameters()]


def pred_tower_rows(dev, record, b, p, timed=True) -> None:
    """The MLP head's tower kernels against their plain version
    (:func:`check_tower`) at B x P, the dense pool's cross form of one edge
    type: in f32 on inputs with a margin (a ``kernel_case`` line, with the
    forward's and the backward's times beside those of the f32 concat head,
    :func:`concat_head_case`), then in bf16 on free inputs (rows
    ``pred_tower_fwd:bf16`` and ``pred_tower_bwd:bf16``).  The yardstick is
    the head the port ran before, in bf16: its forward, and its backward
    alone.  The bound is the tower's least work: layers 2 and 3, 8,256
    operations a pair forward and twice that backward
    (``portbench/counts/pred_nn.py`` without layer 1, whose two products are
    cuBLAS's), at 989 TFLOP/s, or its bytes (the scores, the two halves and,
    backward, the scores' gradient and the halves' gradients), whichever is
    larger."""
    args, ds = pred_tower_case(dev, b, p, torch.float32, margin=True, seed=b)
    err = check_tower(f"pred_tower f32 {b}x{p}", args, ds, None)[:2]
    times = {"ms": None}
    if timed:
        s = pt.pred_tower_fwd(*args)
        concat_head, leaves = concat_head_case(dev, b, p, torch.float32)
        old = concat_head()
        grad = torch.randn(b, p, device=dev)
        times = {"ms": device_ms(lambda: pt.pred_tower_fwd(*args)),
                 "bwd_ms": device_ms(lambda: pt.pred_tower_bwd(ds, s, *args)),
                 "concat_head_fwd_ms": device_ms(concat_head),
                 "concat_head_bwd_ms": device_ms(
                     lambda: torch.autograd.grad(old, leaves, grad, retain_graph=True))}
        del old
    say("kernel_case", name="pred_tower", case=f"f32 B={b} P={p}", shape=[b, p],
        max_abs_err=err[0], grad_gap=err[1], **times)
    args, ds = pred_tower_case(dev, b, p, torch.bfloat16, seed=p)
    fwd_err, bwd_err, s = check_tower(f"pred_tower bf16 {b}x{p}", args, ds, PRED_GRAD_NORM)
    concat_head, leaves = concat_head_case(dev, b, p, torch.bfloat16)
    old = concat_head().float() if timed else None
    pairs, per_pair = b * p, 2.0 * (pt.H1 * pt.H2 + pt.H2)
    halves = 4.0 * (b + p) * pt.H1
    record("pred_tower_fwd:bf16", PRED, 211, fwd_err, lambda: pt.pred_tower_fwd(*args),
           lambda: pt.pred_tower_reference(*args).detach(), concat_head,
           pairs * per_pair, halves + 4.0 * pairs, peak_flops=PEAK_BF16_FLOPS)
    record("pred_tower_bwd:bf16", PRED, 211, bwd_err, lambda: pt.pred_tower_bwd(ds, s, *args),
           lambda: pt.pred_tower_bwd_reference(ds, *args),
           lambda: torch.autograd.grad(old, leaves, ds, retain_graph=True),
           2.0 * pairs * per_pair, 2.0 * halves + 8.0 * pairs, peak_flops=PEAK_BF16_FLOPS,
           grad_norm_gap=bwd_err)


GATHER_KERNELS = ("gather_mean_fwd", "gather_mean_bwd")


class GatherTap:
    """Stands in for the block forward's ``gather_mean`` (``conv_model``).
    While ``counting``, it counts the calls by shape (B, K, N, D) in
    ``calls_by_shape`` and each kernel's launches by shape in
    ``launches[name]``: a forward where the forward wrapper's count moved, a
    backward where the call's CUDA output took its cotangent (the wrapper
    launches on it).  Launches made while a CUDA graph captures go to
    ``in_graph`` instead, which :meth:`take_graph` hands to the captured
    step, and each replay adds them back (:meth:`replayed`), the rule of
    ``train/graph_step.py``.  While ``capturing``, it keeps each call's
    inputs, transpose and cotangent.  ``fn`` is the function it calls (the
    kernels' wrapper, or the plain route)."""

    def __init__(self):
        self.fn = gm.gather_mean
        self.calls_by_shape = collections.Counter()
        self.launches = {name: collections.Counter() for name in GATHER_KERNELS}
        self.in_graph = {name: collections.Counter() for name in GATHER_KERNELS}
        self.captured = []
        self.counting = self.capturing = False

    def __call__(self, h, nbr, mask, transpose=None):
        shape = (nbr.shape[0], nbr.shape[1], h.shape[0], h.shape[1])
        before = gm.gather_mean_fwd.launches
        out = self.fn(h, nbr, mask, transpose)
        if self.counting:
            self.calls_by_shape[shape] += 1
            # A backward runs in the capture of its forward, or outside both.
            into = self.in_graph if h.is_cuda and torch.cuda.is_current_stream_capturing() \
                else self.launches
            into["gather_mean_fwd"][shape] += gm.gather_mean_fwd.launches - before
            if out.requires_grad and out.is_cuda:
                def backward_launched(_, into=into):
                    into["gather_mean_bwd"][shape] += 1
                out.register_hook(backward_launched)
        if self.capturing:
            call = {"shape": shape, "h": h.detach(), "nbr": nbr, "mask": mask,
                    "transpose": transpose}
            self.captured.append(call)
            if out.requires_grad:
                out.register_hook(lambda g, call=call: call.update(dout=g.detach()))
        return out

    def take_graph(self) -> dict:
        """The launches counted during the last capture, taken off."""
        out = self.in_graph
        self.in_graph = {name: collections.Counter() for name in GATHER_KERNELS}
        return out

    def replayed(self, graph_launches: dict) -> None:
        for name, by_shape in graph_launches.items():
            self.launches[name].update(by_shape)

    def check_totals(self, launches: dict, what: str) -> None:
        """Each kernel's launches by shape must add up to its wrapper's
        count ``launches[name]``."""
        sums = {name: sum(self.launches[name].values()) for name in GATHER_KERNELS}
        if any(sums[name] != launches[name] for name in GATHER_KERNELS):
            raise AssertionError(f"{what}: gather-mean launches by shape add up to {sums}, "
                                 f"the wrappers counted {launches}")


def slot_stats(nbr, mask, n, rows) -> dict:
    """Valid slots pointing at one source row of a gather (ids [B, K] into
    N rows), over all N rows: with every destination row, and without the
    padding rows (those at or past the destination table's unique count
    ``rows``, which nothing reads)."""
    out = {"masked_share": 1.0 - float(mask.float().mean())}
    for key, lim in (("all_rows", nbr.shape[0]), ("without_padding", rows)):
        ids = nbr[:lim][mask[:lim]].long()
        per_row = torch.bincount(ids, minlength=n).float()
        out[key] = {"valid_slots": int(ids.numel()), "max": int(per_row.max()),
                    "p99": float(torch.quantile(per_row, 0.99)),
                    "mean": float(per_row.mean())}
    return out


def run_stats(transpose, n, b, k) -> dict:
    """What the backward walks through ``transpose``: the longest run of one
    table row inside its gather's entries (masked slots included), and the
    chunk slots the any-K design uses (``gm.chunk_plan``) against the bound
    its scratch holds (``gm.chunk_slots``)."""
    lo, hi, cstart = gm.chunk_plan(transpose, n, b, k)
    return {"longest_run": int((hi - lo).max()), "chunks": int(cstart[n]),
            "chunk_slots": gm.chunk_slots(b, k, n)}


def l2_resident_fwd_ms(h, nbr, mask) -> float:
    """Device ms of the same forward on ids folded into the table's first
    4 MB, whose rows stay in L2: the rate the gather reaches when memory
    latency is the L2's."""
    n, d = h.shape
    near = (nbr % max(1, min(n, (4 << 20) // (4 * d)))).contiguous()
    return device_ms(lambda: gm.gather_mean_fwd(h, near, mask))


def check_gather_bwd(what, dh, g, nbr, mask, n, transpose) -> float:
    """The backward kernel's ``dh`` against both plain versions (the walk of
    the same transpose, and ``index_add_`` over every slot; ``GRAD_REL`` of
    the largest entry in f32, ``BF16_RTOL`` in bf16) and against a second
    call, which must give the same bits; returns the largest difference."""
    err = 0.0
    rel = BF16_RTOL if dh.dtype == torch.bfloat16 else GRAD_REL
    for want in (gm.gather_mean_bwd_plain(g, mask, n, transpose),
                 gm.gather_mean_bwd_reference(g, nbr, mask, n)):
        err = max(err, float((dh.float() - want.float()).abs().max()))
        if not err <= rel * max(1.0, float(want.float().abs().max())):
            raise AssertionError(f"{what}: differs by {err}")
    if not torch.equal(dh, gm.gather_mean_bwd(g, nbr, mask, n, transpose)):
        raise AssertionError(f"{what}: two calls differ")
    return err


def gather_label(shape) -> str:
    return "B{}_K{}_N{}".format(*shape)


def phase_gather_steps(dev, tap, timed=True, label=gather_label, bf16=True) -> list:
    """Both gather-mean kernels at each shape one dedup step runs, on that
    step's own plan (the first call of each shape that ``tap`` captured):
    against the plain versions, timed beside the bound, the plain versions
    and ``embedding_bag``, with the slot statistics of every call and the
    forward again on ids that all fall in the table's first 4 MB (its rows
    stay in L2); with ``bf16``, again with the table and the cotangent
    rounded to bf16.  Rows are named by ``label(shape)``.  Returns the rows
    of the kernels line."""
    rows, seen = [], set()
    for i, call in enumerate(tap.captured):
        b, k, n, d = call["shape"]
        nbr, mask, h, g, tr = (call[key] for key in ("nbr", "mask", "h", "dout", "transpose"))
        uniq = int(tr.rows)
        stats = {"call": i, "B": b, "K": k, "N": n, "D": d, "unique_rows": uniq,
                 "padding_rows": b - uniq, "transpose_bytes": 4 * (tr.order.numel() + n + 1),
                 **slot_stats(nbr, mask, n, uniq), **run_stats(tr, n, b, k)}
        say("gather_plan", **stats)
        if call["shape"] in seen:
            continue
        seen.add(call["shape"])
        name = label(call["shape"])
        # f32 as the step ran, then the same plan with the table and the
        # cotangent rounded to bf16 (the bf16 step's gathers have this plan).
        for tag, hh, gg in (("", h, g), ("bf16:", h.bfloat16(), g.bfloat16()))[:2 if bf16 else 1]:
            fwd, _ = gather_check_rows(functools.partial(kernel_row, rows, timed), f"{tag}{name}",
                                       hh, gg, nbr, mask, n, tr, stats)
            if timed and not tag:
                fwd["l2_resident_ms"] = l2_resident_fwd_ms(h, nbr, mask)
                say("gather_l2_probe", name=fwd["name"], ms=fwd["ms"],
                    l2_resident_ms=fwd["l2_resident_ms"])
    return rows


def launch_gaps(fn, reps=200, pad_s=0.1) -> dict:
    """One profile of ``reps`` calls of ``fn`` with ``pad_s`` idle seconds
    at the window's edges: the kernel records and the host's launches it
    kept, and, where they pair up in order, each kernel's start minus its
    launch's start as the profiler places them (min and median us; a
    negative gap means its host and device clocks disagree)."""
    from torch.profiler import ProfilerActivity, profile, schedule

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        fn()
        torch.cuda.synchronize()
        prof.step()
        time.sleep(pad_s)
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        time.sleep(pad_s)
        prof.step()
    events = prof.events()
    kernels = sorted(e.time_range.start for e in events
                     if e.device_type == torch.autograd.DeviceType.CUDA)
    launches = sorted(e.time_range.start for e in events if e.name.startswith("cudaLaunch"))
    out = {"kernels": len(kernels), "launches": len(launches)}
    if kernels and len(kernels) == len(launches):
        gaps = np.asarray(kernels) - np.asarray(launches)
        out.update(gap_min_us=float(gaps.min()), gap_median_us=float(np.median(gaps)))
    return out


def phase_profiler_window(dev, when, profiles=20, reps=(3, 20), pads=(0.0,),
                          shape=(2104, 24, 904, 4)) -> dict:
    """How many kernel records ``torch.profiler`` keeps of a small call
    profiled ``profiles`` times at each count of calls in ``reps`` and each
    idle time in ``pads`` at the edges of the active window, and where it
    places the kernels against their launches (:func:`launch_gaps`).  The
    call is the yardstick that once kept no record late in a run:
    ``embedding_bag``'s forward at B, K, N, D = ``shape`` (a gather plan of
    phase ``etl_cli``).  A profile of r calls should keep r times the call's
    launches; the most any profile kept stands for that."""
    b, k, n, d = shape
    gen = torch.Generator(device=dev).manual_seed(5)
    h = torch.randn(n, d, device=dev, generator=gen)
    nbr = torch.randint(0, n, (b, k), device=dev, generator=gen, dtype=torch.int32)
    mask = torch.rand(b, k, device=dev, generator=gen) < 0.5
    bag, _ = embedding_bag_calls(h, nbr, mask, torch.ones(b, d, device=dev))
    report = {"when": when, "profiles": profiles, "shape": list(shape)}
    for pad in pads:
        for r in reps:
            kept = [sum(count for _, count, _ in profiled_kernels(bag, r, pad_s=pad)[1])
                    for _ in range(profiles)]
            report[f"pad_{pad}_s_reps_{r}"] = {"kept_max": max(kept), "kept_min": min(kept),
                                               "profiles_with_none": kept.count(0)}
    report["launch_gaps"] = launch_gaps(bag)
    say("profiler_window", **report)
    return report


def _assert_recs_valid(recs: dict, bought_rows: np.ndarray, num_items: int) -> None:
    uids = np.fromiter(recs.keys(), dtype=np.int64)
    arr = np.asarray(list(recs.values()), dtype=np.int64)
    if not ((arr == -1) | ((arr >= 0) & (arr < num_items))).all():
        raise AssertionError("a rec is neither a catalog id nor -1")
    rows = bought_rows[uids]
    hit = (arr[:, :, None] == rows[:, None, :]) & (arr[:, :, None] >= 0)
    if hit.any():
        raise AssertionError("an already-bought item was recommended")


def _assert_routes_agree(a: torch.Tensor, b: torch.Tensor, score, gaps=None) -> int:
    """Kernel route ``a`` vs torch route ``b``: rows may differ only where
    the scores of the two lists agree within TOL (near-ties at the fetch
    boundary).  Returns the number of differing rows; each such row's
    largest score gap is appended to ``gaps`` when it is given."""
    diff = torch.nonzero((a != b).any(dim=1)).flatten()
    for r in diff.tolist():
        sa, sb = score(r, a[r]).sort().values, score(r, b[r]).sort().values
        gap = float((sa - sb).abs().max())
        if not gap <= TOL:
            raise AssertionError(f"kernel and torch routes disagree for row {r}")
        if gaps is not None:
            gaps.append(gap)
    return int(diff.numel())


def request_breakdown(run_dir, dev, uids, k, mesh=None) -> dict:
    """Host-clock seconds of the steps of one ``inference_ondemand`` request,
    run one by one (each ends in a device synchronize); with a ``mesh``, the
    sharded embedding pass and ranking (the catalog over axis ``model``)."""
    out = {}

    def step(name, fn):
        t0 = time.perf_counter()
        result = fn()
        sync(dev)
        out[name] = time.perf_counter() - t0
        return result

    run = step("load_run", lambda: load_run(run_dir))
    g = run["graph"]

    def make_model():
        model = ConvModel(**model_kwargs_to_config(run["model_kwargs"]))
        model.load_state_dict(run["params"])
        return model.to(dev)

    model = step("build_model", make_model)
    feats = {nt: g.ndata[nt]["features"] for nt in g.ntypes}
    if mesh is not None:
        # What the sharded pass does first (then a no-op there): capped rows rebuilt whole.
        g = step("uncap", lambda: uncap(g))
    h = step("embed", lambda: infer_embeddings(model, g, feats, ntypes=("user", "item"),
                                                device=dev, mesh=mesh))
    ps = step("bought_table", lambda: bought_table(g))
    if mesh is None:
        step("rank", lambda: get_recs(h["user"], h["item"], uids, k, already_bought=ps,
                                      device=dev).cpu())
    else:
        step("rank", lambda: get_recs_sharded(mesh, h["user"], h["item"], uids, k,
                                              already_bought=ps,
                                              axis=catalog_axis(mesh)).cpu())
    return out


def bench_data(num_users=100_000, num_items=30_000):
    """The synthetic click+purchase graph of ``bench.py:206-216``."""
    return make_synthetic_data(
        num_users=num_users, num_items=num_items, num_groups=64,
        interactions_per_user=10, test_per_user=2, feat_dim=8, with_clicks=True,
        seed=0, max_fanout=32,
    )


def medium_kwargs(graph, hidden=256, out=128) -> dict:
    """The Medium ``ConvModel`` of ``bench.py:218-233`` (f32)."""
    return dict(canonical_etypes=graph.canonical_etypes,
                dims=(("user", 8), ("item", 8), ("hidden", hidden), ("out", out)),
                n_layers=3, aggregator_type="mean_nn", pred="cos", aggregator_hetero="sum",
                embedding_layer=True)


def run_model_kwargs(kw) -> dict:
    """A model's keyword arguments as ``save_run`` writes them (JSON lists)."""
    return dict(kw, canonical_etypes=[list(e) for e in kw["canonical_etypes"]],
                dims=[list(d) for d in kw["dims"]], norm=True, dropout=0.0)


def phase_slice(dev, data, hidden=256, out=128, request_sizes=(1, 128, 4096), k=10,
                on_card=True):
    """Serve the Medium model through the port's entry points on ``dev``;
    returns (the launch counts of the main path, the random weights'
    recall@k)."""
    num_users, num_items = data.num_users, data.num_items
    g = data.graph
    buys_u, buys_i = data.train_pairs[BUYS]
    item_popularity(data)
    kw = medium_kwargs(g, hidden, out)
    model = ConvModel(**kw, generator=torch.Generator().manual_seed(0))
    model_kwargs = run_model_kwargs(kw)
    bought_rows = build_padded_pair_set(buys_u, buys_i, num_src=num_users).rows.numpy()
    feats = {nt: g.ndata[nt]["features"] for nt in g.ntypes}
    rng = np.random.default_rng(1)
    report = {}

    with tempfile.TemporaryDirectory() as run_dir:
        t0 = time.perf_counter()
        save_run(run_dir, model.state_dict(), model_kwargs, hyper_params=HyperParams(),
                 graph=g)
        report["save_run_s"] = time.perf_counter() - t0
        model.to(dev)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        compute_embeddings(model, g, feats, device=dev)  # warm-up
        sync(dev)
        t0 = time.perf_counter()
        h = compute_embeddings(model, g, feats, device=dev)
        sync(dev)
        report["embed_s"] = time.perf_counter() - t0
        for nt, n in (("user", num_users), ("item", num_items)):
            if h[nt].shape != (n, out) or not torch.isfinite(h[nt]).all():
                raise AssertionError(f"{nt} embeddings: shape {tuple(h[nt].shape)} or not finite")

        # The main path: counters from 0, read right after.
        profiling.reset_counters()
        latencies = []
        for n, boost in [(n, False) for n in request_sizes] + [(request_sizes[-1], True)]:
            uids = rng.choice(num_users, n, replace=False).tolist()
            t0 = time.perf_counter()
            recs = inference_ondemand(run_dir, uids, k=k, use_popularity=boost, device=dev)
            sync(dev)
            latencies.append({"users": n, "boost": boost, "s": time.perf_counter() - t0})
            if sorted(recs) != sorted(uids) or any(len(r) != k for r in recs.values()):
                raise AssertionError("inference_ondemand answered other users or widths")
            _assert_recs_valid(recs, bought_rows, num_items)
        t0 = time.perf_counter()
        metrics = get_metrics_at_k(h["user"], h["item"], data.test_ground_truth,
                                   (buys_u, buys_i), k, device=dev)
        sync(dev)
        report["metrics_s"] = time.perf_counter() - t0
        launches = {fn.__name__: fn.launches for fn in (tm.mips_topk, tm.mips_lse, tm.mips_boost)}
        if tm.mlp_topk.launches:
            raise AssertionError("cosine serving launched mlp_topk")
        # Each request's bought table by its route: the graph's rows, or the host pack.
        routes = {"requests": inference_ondemand.requests,
                  "from_graph": bought_table.from_graph, "packed": bought_table.packed}
        if routes["from_graph"] != routes["requests"]:
            raise AssertionError(f"a request packed its bought table on the host: {routes}")
        report["bought_table_routes"] = routes
        report["request_breakdown_s"] = request_breakdown(
            run_dir, dev, rng.choice(num_users, request_sizes[-1], replace=False), k)
    report.update(requests=latencies, launches=launches,
                  precision_recall_coverage=metrics)
    if on_card and not all(launches.values()):
        raise AssertionError(f"a kernel of the serving path never launched: {launches}")
    if not all(np.isfinite(metrics)) or not 0 <= metrics[1] <= 1:
        raise AssertionError(f"bad metrics {metrics}")

    # Kernel route against the torch route on the same embeddings.
    ps = build_padded_pair_set(buys_u, buys_i, num_src=num_users)
    uids = torch.as_tensor(rng.choice(num_users, request_sizes[-1], replace=False), device=dev)
    ue, ie = l2_normalize(h["user"]), l2_normalize(h["item"])
    pop = g.ndata["item"]["popularity"].reshape(-1).to(dev)
    cos = dot_scores(ue, ie)
    lse = torch.logsumexp(ue[uids].double() @ ie.double().T, dim=1)  # [len(uids)]
    differing = {}
    for boost in (False, True):
        route_kw = dict(already_bought=ps, device=dev, popularity=pop if boost else None)
        a = get_recs(h["user"], h["item"], uids, k, backend="cuda", **route_kw)
        b = get_recs(h["user"], h["item"], uids, k, backend="torch", **route_kw)

        def score(r, items, boost=boost):
            items = items[items >= 0]
            s = cos(uids[r].expand_as(items), items)
            return torch.exp(s - lse[r]) + pop[items].double() if boost else s

        differing["boost" if boost else "cos"] = _assert_routes_agree(a, b, score)
    report["routes_differing_rows"] = differing

    # The device's embeddings against the CPU's on a small graph (same weights).
    small = make_synthetic_data(num_users=500, num_items=200, seed=2).graph
    small_model = ConvModel(**dict(kw, canonical_etypes=small.canonical_etypes),
                            generator=torch.Generator().manual_seed(0))
    small_feats = {nt: small.ndata[nt]["features"] for nt in small.ntypes}
    on_cpu = compute_embeddings(small_model, small, small_feats, device="cpu")
    on_dev = compute_embeddings(small_model.to(dev), small, small_feats, device=dev)
    err = max(float((on_cpu[nt] - on_dev[nt].cpu()).abs().max()) for nt in on_cpu)
    if not err <= TOL:
        raise AssertionError(f"device and CPU embeddings differ by {err}")
    report["embed_device_vs_cpu_max_abs_err"] = err

    if on_card:
        # Full-catalog ranking of every user at the over-fetch width, alone.
        fetch = k + int(bought_rows.shape[1])
        report["rank_all_users"] = {
            "users": num_users, "fetch": fetch,
            "kernel_ms": time_ms(lambda: tm.mips_topk(ue, ie, fetch), reps=3, warmup=1),
            "plain_ms": time_ms(lambda: tm.mips_topk_reference(ue, ie, fetch), reps=1,
                                warmup=1),
            # The same with the popularity boost: mips_lse, then mips_boost.
            "boosted_kernel_ms": time_ms(lambda: tm.mips_topk_boosted(ue, ie, pop, fetch),
                                         reps=3, warmup=1),
            "boosted_plain_ms": time_ms(
                lambda: tm.mips_topk_boosted_reference(ue, ie, pop, fetch), reps=1, warmup=1),
        }
        report["max_memory_allocated_bytes"] = torch.cuda.max_memory_allocated(dev)
    say("slice", **report)
    return launches, metrics[1]


# The kernels of phase sharded_serving's path: the MIPS epilogues on each
# catalog shard, the leaf forward in the sharded embedding pass.
SHARDED_ROWS = ("mips_topk", "mips_lse", "mips_boost", "leaf_mean_nn_fwd")
# A sharded embedding pass against the full-graph pass: the JAX package's
# tolerance (tests/test_sharded_serving.py:196-198).
EMB_RTOL, EMB_ATOL = 2e-5, 2e-6


def sharded_counts() -> dict:
    return {"mips_topk": tm.mips_topk.launches, "mips_lse": tm.mips_lse.launches,
            "mips_boost": tm.mips_boost.launches,
            "leaf_mean_nn_fwd": la.leaf_mean_nn_fwd.launches}


def card_mesh(dev, shards: int) -> Mesh:
    """``shards`` catalog shards on one device: a ('data'=1, 'model'=shards)
    mesh whose entries all name ``dev``."""
    return make_mesh(shards, data_axis=1, devices=[dev] * shards)


def sync_all(devices) -> None:
    for d in dict.fromkeys(devices):
        sync(d)


def embedding_gap(out: dict, ref: dict) -> float:
    """Largest |out - ref| over both node types; raises where an entry lies
    beyond EMB_ATOL + EMB_RTOL * |ref|."""
    err = 0.0
    for nt in ("user", "item"):
        a, b = out[nt].to(ref[nt].device), ref[nt]
        if a.shape != b.shape or not ((a - b).abs() <= EMB_ATOL + EMB_RTOL * b.abs()).all():
            raise AssertionError(f"sharded {nt} embeddings beyond rtol {EMB_RTOL}, atol {EMB_ATOL}")
        err = max(err, float((a - b).abs().max()))
    return err


def recs_tensor(recs: dict, uids) -> torch.Tensor:
    return torch.tensor([recs[u] for u in uids], dtype=torch.int64)


def cli_recs(text: str) -> dict:
    """``main_inference``'s printed lines, ``uid: [items]``, as a dict."""
    out = {}
    for line in text.strip().splitlines():
        uid, items = line.split(": ", 1)
        out[uid] = json.loads(items)
    return out


def boosted_score(h, pop):
    """f64 boosted scores of user ``r`` (row ``r`` ranks node ``r``) at
    ``items`` (-1 dropped): the softmax over the whole catalog plus the
    popularity, for :func:`_assert_routes_agree`."""
    ue, ie = l2_normalize(h["user"]).double(), l2_normalize(h["item"]).double()

    def score(r, items):
        items = items[items >= 0]
        s = ue[r] @ ie.T
        return torch.exp(s[items] - torch.logsumexp(s, 0)) + pop[items].double()

    return score


def tree_leaf_launches(graph, ntypes, shards: int, node_chunk: int, levels: int) -> int:
    """Leaf-kernel launches of a sharded embedding pass: each shard's chunks
    of each node type (the ids split into ``shards`` runs, the first ``n %
    shards`` one longer), one launch a leaf branch of a seed's tree."""
    total = 0
    for nt in ntypes:
        n = graph.num_nodes(nt)
        sizes = [n // shards + (j < n % shards) for j in range(shards)]
        chunks = sum(-(-size // node_chunk) for size in sizes)
        total += chunks * leaf_branches(graph, nt, levels)
    return total


def phase_sharded_serving(dev, data, hidden=256, out=128, shard_counts=(4, 7), k=10,
                          request_users=4096, cli_users=64, node_chunk=1024, on_card=True) -> dict:
    """Serve the Medium model of phase ``slice`` over meshes whose catalog
    shards all sit on ``dev``, then over the real cards where there are
    several; returns the launch counts of the phase's main path."""
    t_phase = time.perf_counter()
    num_users, num_items = data.num_users, data.num_items
    g = data.graph
    pop = item_popularity(data).reshape(-1).to(dev)
    kw = medium_kwargs(g, hidden, out)
    model = ConvModel(**kw, generator=torch.Generator().manual_seed(0))
    leaf_model = ConvModel(**kw, leaf_kernel=True)
    leaf_model.load_state_dict(model.state_dict())
    feats = {nt: g.ndata[nt]["features"] for nt in g.ntypes}
    ps = build_padded_pair_set(*already_bought_from_graph(g), num_src=num_users).to(dev)
    bought_rows = ps.rows.cpu().numpy()
    rng = np.random.default_rng(3)
    req_ids = rng.choice(num_users, request_users, replace=False).tolist()
    cli_ids = rng.choice(num_users, cli_users, replace=False).tolist()
    meshes = {m: card_mesh(dev, m) for m in shard_counts}
    request_mesh = meshes[shard_counts[0]]
    uids = torch.arange(num_users, device=dev)
    report = {"shard_counts": list(shard_counts), "node_chunk": node_chunk,
              "fetch": k + ps.max_row}

    with tempfile.TemporaryDirectory() as run_dir:
        save_run(run_dir, model.state_dict(), run_model_kwargs(kw), hyper_params=HyperParams(),
                 graph=g)
        model.to(dev)
        leaf_model.to(dev)
        # The references, before the counted path: the full-graph embeddings,
        # single-device ranking of every user, the requests and the CLI.
        h = compute_embeddings(model, g, feats, device=dev)
        full = uncap(g).to(dev)  # the graph the sharded pass reads, rebuilt once
        ranked = dict(already_bought=ps, device=dev, chunk_size=1024)
        ref = {False: get_recs(h["user"], h["item"], uids, k, backend="cuda", **ranked),
               True: get_recs(h["user"], h["item"], uids, k, popularity=pop, backend="torch",
                              **ranked)}
        ref_torch = get_recs(h["user"], h["item"], uids, k, backend="torch", **ranked)
        ref_request = inference_ondemand(run_dir, req_ids, k=k, device=dev)
        argv = ["--run-dir", run_dir, "--k", str(k), "--device", str(dev)]
        argv += [a for u in cli_ids for a in ("--user-ids", str(u))]
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            main_inference.main(argv)
        cli_ref = buf.getvalue()

        # The main path: counts from 0, read right after.
        profiling.reset_counters()
        runs = {}
        for m, mesh in meshes.items():
            for boost in (False, True):
                before = sharded_counts()
                t0 = time.perf_counter()
                recs = get_recs_sharded(mesh, h["user"], h["item"], uids, k, already_bought=ps,
                                        popularity=pop if boost else None, backend="cuda")
                sync(dev)
                secs = time.perf_counter() - t0
                grown = {n: c - before[n] for n, c in sharded_counts().items()}
                runs[m, boost] = (recs, secs, grown)
        before = sharded_counts()
        t0 = time.perf_counter()
        request = inference_ondemand(run_dir, req_ids, k=k, device=dev, mesh=request_mesh)
        sync(dev)
        report["request"] = {"users": request_users, "shards": shard_counts[0],
                             "s": time.perf_counter() - t0,
                             "launches": {n: c - before[n] for n, c in sharded_counts().items()}}
        embeds = {}
        for name, mdl in (("mean_nn", model), ("mean_nn_leaf_kernel", leaf_model)):
            if dev.type == "cuda":
                torch.cuda.reset_peak_memory_stats(dev)
            before = sharded_counts()
            t0 = time.perf_counter()
            emb = infer_embeddings_sharded(mdl, full, feats, request_mesh, node_chunk=node_chunk)
            sync(dev)
            embeds[name] = {
                "s": time.perf_counter() - t0,
                "max_memory_allocated_bytes": (torch.cuda.max_memory_allocated(dev)
                                               if dev.type == "cuda" else None),
                "leaf_launches": la.leaf_mean_nn_fwd.launches - before["leaf_mean_nn_fwd"],
                "max_abs_err": embedding_gap(emb, h)}
        launches = sharded_counts()

        # The CLI with --mesh 1 in a process of its own, against the one above.
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "gnn_recsys_tpu_torch.cli.main_inference", *argv, "--mesh", "1"],
            capture_output=True, text=True, timeout=600,
            cwd=os.path.dirname(os.path.abspath(__file__)))
        if proc.returncode:
            raise RuntimeError(f"main_inference --mesh 1 exited {proc.returncode}: "
                               f"{proc.stderr[-2000:]}")
        cli_s = time.perf_counter() - t0
        report["request_breakdown_s"] = request_breakdown(run_dir, dev, req_ids, k,
                                                          mesh=request_mesh)

    # Checks.  Unboosted: the same kernel on the same normalised rows, so
    # every row equal to the kernel route's, and against the torch route
    # with the near-tie rule; boosted: the shards' statistics combine in
    # another order than one pass's, so rows may differ at near-ties.
    ue, ie = l2_normalize(h["user"]).double(), l2_normalize(h["item"]).double()
    boost_score = boosted_score(h, pop)

    def cos_score(users):
        return lambda r, items: ue[users[r]] @ ie[items[items >= 0]].T

    all_cos = cos_score(uids)

    report["rank_all_users"] = []
    for (m, boost), (recs, secs, grown) in runs.items():
        want = {"mips_topk": 0 if boost else m, "mips_lse": m if boost else 0,
                "mips_boost": m if boost else 0, "leaf_mean_nn_fwd": 0}
        if grown != (want if on_card else dict.fromkeys(want, 0)):
            raise AssertionError(f"{m} shards, boost {boost}: launches {grown}, not {want}")
        _assert_recs_valid(dict(enumerate(recs.cpu().tolist())), bought_rows, num_items)
        gaps = []
        if boost:
            differing = _assert_routes_agree(recs, ref[True], boost_score, gaps)
        else:
            differing = int((recs != ref[False]).any(dim=1).sum())
            if differing:
                raise AssertionError(f"{m} shards: {differing} rows differ from get_recs")
            differing = _assert_routes_agree(recs, ref_torch, all_cos, gaps)
        report["rank_all_users"].append({
            "users": num_users, "shards": m, "boost": boost, "s": secs, "launches": grown,
            "rows_differing": differing, "largest_score_gap": max(gaps, default=0.0)})

    # The mesh's embeddings are the full-graph pass's up to the order of
    # sums, so a request's rows may differ from mesh=None's at near-ties only.
    report["request"]["rows_differing"] = _assert_routes_agree(
        recs_tensor(request, req_ids).to(dev), recs_tensor(ref_request, req_ids).to(dev),
        cos_score(torch.as_tensor(req_ids, device=dev)))
    want_leaf = tree_leaf_launches(g, g.ntypes, shard_counts[0], node_chunk,
                                   model.num_conv_layers)
    if on_card and (embeds["mean_nn"]["leaf_launches"]
                    or embeds["mean_nn_leaf_kernel"]["leaf_launches"] != want_leaf):
        raise AssertionError(f"leaf launches {embeds}, not 0 and {want_leaf}")
    report["embeddings"] = embeds
    report["embeddings_expected_leaf_launches"] = want_leaf

    mesh_cli, plain_cli = cli_recs(proc.stdout), cli_recs(cli_ref)
    if sorted(mesh_cli) != sorted(plain_cli):
        raise AssertionError("main_inference --mesh 1 answered other users")
    cli_users_t = torch.as_tensor(cli_ids, device=dev)
    report["cli_mesh_1"] = {"s": cli_s, "users": cli_users, "identical": proc.stdout == cli_ref,
                            "rows_differing": _assert_routes_agree(
                                recs_tensor(mesh_cli, [str(u) for u in cli_ids]).to(dev),
                                recs_tensor(plain_cli, [str(u) for u in cli_ids]).to(dev),
                                cos_score(cli_users_t))}

    if on_card:
        report["timed"] = sharded_times(dev, meshes, h, ps, pop, k)
        if torch.cuda.device_count() > 1:
            report["cards"] = sharded_over_cards(h, ps, pop, k, ref, ref_torch, full, feats, model,
                                                 node_chunk, embeds["mean_nn"]["s"])
    report.update(launches=launches, seconds=time.perf_counter() - t_phase)
    say("sharded_serving", **report)
    return launches


def shard_topk_inputs(mesh, h, fetch):
    """Each shard's device, normalised users, real catalog rows and width
    ``min(fl, rows)``, as the ``cuda`` route lays them out."""
    devices = mesh.shard_devices("model")
    blocks, _, n = shard_catalog(mesh, h["item"], axis="model")
    per = blocks[0].shape[0]
    fl = min(fetch, per)
    users = {d: l2_normalize(h["user"].to(d)) for d in dict.fromkeys(devices)}
    out = []
    for j, (d, b) in enumerate(zip(devices, blocks)):
        rows = max(0, min(per, n - j * per))
        out.append((d, users[d], l2_normalize(b[:rows]), min(fl, rows), j * per))
    return out, fl


def sharded_times(dev, meshes, h, ps, pop, k) -> list:
    """On one card: each mesh's sharded ranking of every user (CUDA events,
    3 calls), plain and boosted, beside single-device ``get_recs``; each
    shard's ``mips_topk`` alone and the merge alone."""
    uids = torch.arange(h["user"].shape[0], device=dev)
    fetch = k + ps.max_row
    rows = []
    single = {boost: time_ms(lambda boost=boost: get_recs(
        h["user"], h["item"], uids, k, already_bought=ps, popularity=pop if boost else None,
        backend="cuda", device=dev), reps=3, warmup=1) for boost in (False, True)}
    for m, mesh in meshes.items():
        shards, fl = shard_topk_inputs(mesh, h, fetch)
        shard_ms, vals, idx = [], [], []
        for d, ue, ie, kj, lo in shards:
            shard_ms.append(time_ms(lambda ue=ue, ie=ie, kj=kj: tm.mips_topk(ue, ie, kj),
                                    reps=3, warmup=1))
            v, i = tm.mips_topk(ue, ie, kj)
            vals.append(torch.nn.functional.pad(v, (0, fl - kj), value=float("-inf")))
            idx.append(torch.nn.functional.pad(i + lo, (0, fl - kj), value=-1))
        row = {"shards": m, "fl": fl, "shard_mips_topk_ms": shard_ms,
               "merge_ms": time_ms(lambda: merge_candidates(vals, idx, fetch, dev), reps=3,
                                   warmup=1)}
        for boost in (False, True):
            row["boosted_ms" if boost else "ms"] = time_ms(
                lambda boost=boost, mesh=mesh: get_recs_sharded(
                    mesh, h["user"], h["item"], uids, k, already_bought=ps,
                    popularity=pop if boost else None, backend="cuda"), reps=3, warmup=1)
            row["single_device_boosted_ms" if boost else "single_device_ms"] = single[boost]
        rows.append(row)
    return rows


def sharded_over_cards(h, ps, pop, k, ref, ref_torch, full, feats, model, node_chunk,
                       one_card_embed_s) -> dict:
    """The same ranking and embedding pass (of the uncapped graph ``full``)
    over every card (one shard a card): the same checks, and whether the
    shards overlapped (the sharded call's wall time against the sum of the
    shards' ``mips_topk`` times, each alone on its card)."""
    n = torch.cuda.device_count()
    mesh = make_mesh(n, data_axis=1)
    devices = mesh.shard_devices("model")
    home = devices[0]
    uids = torch.arange(h["user"].shape[0], device=home)
    out = {"cards": n, "devices": [torch.cuda.get_device_name(d) for d in devices]}
    for boost in (False, True):
        recs = get_recs_sharded(mesh, h["user"], h["item"], uids, k, already_bought=ps,
                                popularity=pop if boost else None, backend="cuda")
        sync_all(devices)
        if boost:
            out["boosted_rows_differing"] = _assert_routes_agree(recs, ref[True],
                                                                 boosted_score(h, pop))
            continue
        if not torch.equal(recs, ref[False]):
            raise AssertionError("ranking over the cards differs from get_recs")
        ue, ie = l2_normalize(h["user"]).double(), l2_normalize(h["item"]).double()
        out["rows_differing_from_torch_route"] = _assert_routes_agree(
            recs.to(ref_torch.device), ref_torch,
            lambda r, items: ue[r] @ ie[items[items >= 0]].T)
    walls = []
    for _ in range(3):
        sync_all(devices)
        t0 = time.perf_counter()
        get_recs_sharded(mesh, h["user"], h["item"], uids, k, already_bought=ps, backend="cuda")
        sync_all(devices)
        walls.append((time.perf_counter() - t0) * 1e3)
    shards, _ = shard_topk_inputs(mesh, h, k + ps.max_row)
    shard_ms = []
    for d, ue, ie, kj, _ in shards:
        with torch.cuda.device(d):
            shard_ms.append(time_ms(lambda ue=ue, ie=ie, kj=kj: tm.mips_topk(ue, ie, kj),
                                    reps=3, warmup=1))
    out.update(wall_ms=walls, shard_mips_topk_ms=shard_ms,
               overlapped=min(walls) < sum(shard_ms))
    t0 = time.perf_counter()
    emb = infer_embeddings_sharded(model, full, feats, mesh, node_chunk=node_chunk)
    sync_all(devices)
    out["embeddings"] = {"s": time.perf_counter() - t0, "one_card_4_shards_s": one_card_embed_s,
                         "max_abs_err": embedding_gap(emb, h)}
    return out


def leaf_branches(graph, ntype: str, level: int) -> int:
    """Leaf-kernel branches of one seed's tree: every in-etype of a level-1
    node (``_tree_level``: the self subtree, then each in-etype's)."""
    in_etypes = [et for et in graph.canonical_etypes if et[2] == ntype]
    if level == 1:
        return len(in_etypes)
    return leaf_branches(graph, ntype, level - 1) + sum(
        leaf_branches(graph, et[0], level - 1) for et in in_etypes)


def block_means(graph, seed_ntypes, levels: int) -> int:
    """Gather-mean launches of one dedup'd block forward: one per (level,
    node type of that level's table, in-etype), as its plan walks them
    (``_sampled_repr_dedup``: a level's table holds the node types above it
    and their in-etypes' sources)."""
    ntypes, means = list(seed_ntypes), 0
    for _ in range(levels):
        in_etypes = [et for nt in ntypes for et in graph.canonical_etypes if et[2] == nt]
        means += len(in_etypes)
        ntypes += [et[0] for et in in_etypes if et[0] not in ntypes]
    return means


def _grads(model) -> dict:
    return {n: (p.grad.clone() if p.grad is not None else torch.zeros_like(p))
            for n, p in model.named_parameters()}


def same_grads_twice(run) -> bool:
    """Runs ``run`` (-> (loss, gradients)) twice with PyTorch's deterministic
    algorithms on, and raises unless both give the same bits.  Without them,
    ``index_add_`` (the backward of the block forward's row takes) adds with
    atomics on CUDA; the gather-mean backward has none either way."""
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        (la_, ga), (lb, gb) = run(), run()
    finally:
        torch.use_deterministic_algorithms(was)
    differing = [name for name in ga if not torch.equal(ga[name], gb[name])]
    if la_ != lb or differing:
        raise AssertionError(f"two steps from the same state differ: loss {la_} vs {lb}, "
                             f"gradients {differing}")
    return True


def phase_train(dev, data, hidden=256, out=128, steps=200, batch_size=2048, pool=2560,
                fanouts=(8, 4), random_recall=None, k=10, on_card=True, tap=None):
    """Train the Medium model with the ``bench.py`` step on ``dev``; with a
    :class:`GatherTap` ``tap``, through the dedup'd block forward, whose
    gather-mean calls go through ``tap`` (counted in the main path, captured
    in the route check's kernel step).  Returns (the launch counts of the
    main path, the trained model)."""
    dedup = tap is not None
    if dedup:
        conv_model.gather_mean = tap
    try:
        phase = "train_dedup" if dedup else "train"
        g = data.graph.to(dev)
        feats = {nt: g.ndata[nt]["features"] for nt in g.ntypes}
        kw = medium_kwargs(g, hidden, out)
        model = ConvModel(**kw, leaf_kernel=True)
        init_model(model, seed=0)  # the slice phase's random weights
        model.to(dev)
        cfg = MinibatchConfig(edge_batch_size=batch_size, fanouts=tuple(fanouts),
                              neg_mode="dense_pool", neg_pool_size=pool, pool_mask_kernel=True,
                              dedup=dedup)
        etypes = tuple(data.train_pairs)
        has_reverse = {et: True for et in etypes}
        tables = {et: build_padded_pair_set(u, i, num_src=data.num_users).to(dev)
                  for et, (u, i) in data.train_pairs.items()}
        state = TrainState.create(model, lr=cfg.lr)
        step = make_minibatch_step(model, cfg, etypes, with_update=True, with_exclusion=True,
                                   has_reverse=has_reverse)
        store = EdgeStore(data.graph, etypes)
        batches = iter_edge_batches(np.random.default_rng(0),
                                    {et: np.arange(g.num_edges(et)) for et in etypes}, batch_size)
        draws = Draws(torch.Generator(device=dev).manual_seed(0))
        per_step = step_counts(g, model, etypes, dedup)
        counters = {"leaf_mean_nn_fwd": la.leaf_mean_nn_fwd,
                    "leaf_mean_nn_bwd": la.leaf_mean_nn_bwd,
                    "pool_membership_mask": pm.pool_membership_mask,
                    "gather_mean_fwd": gm.gather_mean_fwd, "gather_mean_bwd": gm.gather_mean_bwd}

        # The main path: counters from 0, read right after.
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        profiling.reset_counters()
        if dedup:
            tap.counting = True
        losses, events = [], []
        t0 = time.perf_counter()
        for _ in range(steps):
            if dev.type == "cuda":  # the window holds the batch's assembly too
                events.append((torch.cuda.Event(enable_timing=True),
                               torch.cuda.Event(enable_timing=True)))
                events[-1][0].record()
            batch = store.batch(next(batches), True, dev)
            _, loss = step(state, g, feats, batch, tables, draws)
            if dev.type == "cuda":
                events[-1][1].record()
            losses.append(loss)
        sync(dev)
        train_s = time.perf_counter() - t0
        launches = {name: fn.launches for name, fn in counters.items()}
        if dedup:
            tap.counting = False
            tap.check_totals(launches, phase)
            calls = sum(tap.calls_by_shape.values())
            if on_card and not calls == launches["gather_mean_fwd"] == launches["gather_mean_bwd"]:
                raise AssertionError(f"{calls} gather-mean calls against {launches} launches")
        losses = torch.stack(losses).cpu().numpy()
        window = max(1, min(20, steps // 5))
        first, last = float(losses[:window].mean()), float(losses[-window:].mean())
        edges = sum(len(v["u"]) for v in batch.values())
        report = {"steps": steps, "edges_per_step": edges, "train_s": train_s,
                  "edges_per_s": steps * edges / train_s,
                  "loss_first_mean": first, "loss_last_mean": last,
                  "window": window, "launches": launches, "launches_per_step": per_step}
        if events:
            step_ms = [a.elapsed_time(b) for a, b in events]
            report.update(step_ms_median=float(np.median(step_ms)),
                          step_ms_min=float(np.min(step_ms)), step_ms_max=float(np.max(step_ms)),
                          max_memory_allocated_bytes=torch.cuda.max_memory_allocated(dev))
        if not np.isfinite(losses).all() or not last < first:
            raise AssertionError(f"the loss is not finite or does not fall: {first} -> {last}")
        for name, n in per_step.items():
            want = n * steps if on_card else 0
            if launches[name] != want:
                raise AssertionError(f"{name}: {launches[name]} launches, expected {want}")
        if on_card:
            report["profile"] = profile_steps(
                lambda: step(state, g, feats, store.batch(next(batches), True, dev), tables, draws))

        # One step through the kernels and through the plain route, same
        # parameters, batch and draws: loss and gradients must agree.  The
        # tree's plain route is the model without the leaf kernel; the dedup'd
        # block forward has no such switch (nor has the JAX package), so its
        # tap calls the forward's plain version for that one step.  Two more
        # kernel steps of the dedup'd route must give the same bits.
        plain = ConvModel(**kw, leaf_kernel=False).to(dev)
        plain.load_state_dict(model.state_dict())
        batch = store.batch(next(batches), True, dev)

        def loss_and_grads(m, c, step_draws):
            m.train()
            m.zero_grad(set_to_none=True)
            loss = make_minibatch_loss(m, c, etypes, True, has_reverse)(
                g, feats, batch, tables, step_draws)
            loss.backward()
            return float(loss.detach()), _grads(m)

        rec = Draws(torch.Generator(device=dev).manual_seed(1), record=True)
        if dedup:
            tap.capturing = True
        lk, gk = loss_and_grads(model, cfg, rec)
        if dedup:
            tap.capturing = False
            report["bit_identical_grads"] = same_grads_twice(
                lambda: loss_and_grads(model, cfg, rec.replay()))
            tap.fn = plain_gather_mean
        lp, gp = loss_and_grads(plain, dataclasses.replace(cfg, pool_mask_kernel=False),
                                rec.replay())
        if not abs(lk - lp) <= LOSS_RTOL * abs(lp):
            raise AssertionError(f"{phase}: kernel and plain routes: loss {lk} vs {lp}")
        worst = 0.0
        for name, a in gk.items():
            excess = ((a - gp[name]).abs() - STEP_GRAD_RTOL * gp[name].abs()).max()
            worst = max(worst, float(excess))
        if not worst <= STEP_GRAD_ATOL:
            raise AssertionError(f"{phase}: kernel and plain routes: gradients differ by {worst} "
                                 f"beyond rtol {STEP_GRAD_RTOL}")
        report["routes"] = {"loss_kernel": lk, "loss_plain": lp, "grad_excess_over_rtol": worst}

        # The trained model's quality against the random weights'.
        h = compute_embeddings(model, g, feats, device=dev)
        metrics = get_metrics_at_k(h["user"], h["item"], data.test_ground_truth,
                                   data.train_pairs[BUYS], k, device=dev)
        report["precision_recall_coverage"] = metrics
        report["random_weights_recall"] = random_recall
        if random_recall is not None and not metrics[1] > random_recall:
            raise AssertionError(f"trained recall@{k} {metrics[1]} <= random weights' "
                                 f"{random_recall}")
        say(phase, **report)
        return launches, model
    finally:
        conv_model.gather_mean = gm.gather_mean


# Kernel names of the training kernels in a profile, for the replayed step's
# launch counts (``leaf_bwd_kernel`` leaves out the backward's reduce).
REPLAY_KERNELS = {"leaf_mean_nn_fwd": "leaf_fwd_kernel", "leaf_mean_nn_bwd": "leaf_bwd_kernel",
                  "pool_membership_mask": "pool_mask_kernel",
                  "gather_mean_fwd": "gather_mean_fwd_kernel",
                  "gather_mean_bwd": "gather_mean_bwd_kernel"}
# The LSTM cell update's kernels, counted alike in the LSTM phases (15-17).
LSTM_CELL_KERNELS = {"lstm_cell_fwd": "lstm_cell_fwd_kernel",
                     "lstm_cell_bwd": "lstm_cell_bwd_kernel"}
# The MLP head's tower kernels, a launch of each a call (train_graph_nn_bf16).
PRED_TOWER_KERNELS = {"pred_tower_fwd": "pred_tower_fwd_kernel",
                      "pred_tower_bwd": "pred_tower_bwd_kernel"}


def step_counts(graph, model, etypes, dedup: bool) -> dict:
    """Launches of each training kernel in one step of the bench config:
    12 leaf-kernel branches a tree step, 8 gather-means a dedup step, one
    pool mask an etype."""
    leaves = 0 if dedup else sum(leaf_branches(graph, nt, model.num_conv_layers)
                                 for nt in ("user", "item"))
    means = block_means(graph, ("user", "item"), model.num_conv_layers) if dedup else 0
    out = {"leaf_mean_nn_fwd": leaves, "leaf_mean_nn_bwd": leaves,
           "pool_membership_mask": len(etypes), "gather_mean_fwd": means,
           "gather_mean_bwd": means}
    if model.pred == "nn":  # the tower on the dense pool, an etype
        out.update(pred_tower_fwd=len(etypes), pred_tower_bwd=len(etypes))
    return out


def edge_slices(graph, etypes, edges: int, skip: dict = None) -> dict:
    """Per etype, a run of edge ids (after ``skip[et]`` of them) whose
    lengths share ``edges`` in proportion to the etypes' edge counts."""
    total = sum(graph.num_edges(et) for et in etypes)
    out = {}
    for et in etypes:
        lo = (skip or {}).get(et, 0)
        out[et] = np.arange(lo, lo + round(edges * graph.num_edges(et) / total))
    return out


def graph_route_check(dev, g, feats, kw, cfg, eids, tables, per_step, steps=10,
                      on_card=True, seed=1) -> tuple:
    """``steps`` steps through the device epochs' eager body and as many
    replays of their CUDA graph (on the CPU: the eager body twice), from one
    state, permutation and seed: the first step's draws bit for bit, each
    step's loss within ``LOSS_RTOL`` and, after each Adam update, the
    parameters within the Adam tolerance of ``tests/test_torch_minibatch.py``
    (2e-6 where the eager step's |g| > 1e-5, else 2 * lr), and the graph's
    captured launches equal to ``per_step``.  Before each step after the
    first, the graph's parameters and Adam state are set to the eager
    route's, so that each replay is held against one eager update from the
    same state (the dedup step's ``index_add_`` adds with atomics, and the
    routes' last bits part over several updates).  A bf16 model
    (``kw["dtype"]``) has the loss within ``LOSS_RTOL`` too (its forward has
    no atomics), each gradient within ``BF16_ROUTE_GRAD_REL`` of its
    parameter's largest entry, and the parameters within ``UPDATE_REL * lr``
    where the eager step's |g| exceeds ``ABOVE_GAP`` times the parameter's
    largest gradient gap, else within 2 * lr (the atomics' order moves a
    bf16 gradient entry by an ulp, and Adam turns a small gradient's
    relative change into up to about lr).  Returns (the report, the captured
    step or None)."""
    etypes = tuple(eids)
    counts = {et: len(v) for et, v in eids.items()}
    store = device_edge_store(g, etypes, dev)
    eids_dev = {et: torch.as_tensor(v, device=dev) for et, v in eids.items()}
    routes = []
    for capture in (False, on_card):
        model = ConvModel(**kw, leaf_kernel=True)
        init_model(model, seed=0)
        model.to(dev)
        state = TrainState.create(model, lr=cfg.lr)
        if on_card:  # both routes update with the same (capturable) Adam
            state.make_capturable()
        perm_fn, chunk_fn = make_epoch_fns(model, cfg, etypes, True, True,
                                           {et: True for et in etypes}, counts, capture=capture)
        gen = torch.Generator(device=dev).manual_seed(seed)
        routes.append({"model": model, "state": state, "chunk_fn": chunk_fn,
                       "perms": perm_fn(eids_dev, gen), "draws": Draws(gen, record=True)})
    eager, graph = routes
    if not all(torch.equal(eager["perms"][et], graph["perms"][et]) for et in etypes):
        raise AssertionError("the two routes drew different permutations")
    pa, pb = (dict(r["model"].named_parameters()) for r in routes)
    bf16 = kw.get("dtype") == torch.bfloat16
    worst_loss = worst_gap = worst_grad = worst_update = 0.0
    tight = 0
    with warnings.catch_warnings(), torch.no_grad():
        warnings.filterwarnings("ignore", message=".*capturable=True.*")
        for k in range(steps):
            if k:  # the graph starts from the eager route's state
                for n, p in pa.items():
                    pb[n].copy_(p)
                    sa, sb = eager["state"].tx.state[p], graph["state"].tx.state[pb[n]]
                    for key, v in sa.items():
                        sb[key].copy_(v)
            with torch.enable_grad():
                la, lb = (float(r["chunk_fn"](r["state"], g, feats, tables, store, r["perms"],
                                              k, r["draws"], n_steps=1)[1][0]) for r in routes)
            if k == 0:
                first_draws = {"pool": int(eager["draws"].randints[0].numel())}
                for kind in ("randints", "uniforms"):
                    a, b = getattr(eager["draws"], kind), getattr(graph["draws"], kind)
                    if len(a) != len(b) or not all(torch.equal(x, y) for x, y in zip(a, b)):
                        raise AssertionError(f"step 1's {kind} differ between the routes")
                    first_draws[kind] = len(a)
                for r in routes:  # the graph's lists stay its captured draws
                    r["draws"].uniforms = r["draws"].randints = None
            worst_loss = max(worst_loss, abs(la - lb) / abs(la))
            if not abs(la - lb) <= LOSS_RTOL * abs(la):
                raise AssertionError(f"step {k}: eager loss {la}, graph loss {lb}")
            for n, p in pa.items():
                grad = p.grad if p.grad is not None else torch.zeros_like(p)
                if bf16:
                    other = pb[n].grad if pb[n].grad is not None else torch.zeros_like(p)
                    gap = float((grad - other).abs().max())
                    rel = gap / max(float(grad.abs().max()), 1e-30)
                    worst_grad = max(worst_grad, rel)
                    if not rel <= BF16_ROUTE_GRAD_REL:
                        raise AssertionError(f"step {k}: {n}'s gradients differ by {rel} of "
                                             f"its largest entry")
                    above = grad.abs() > ABOVE_GAP * gap
                    tight += int(above.sum())
                    if above.any():
                        worst_update = max(worst_update,
                                           float((p - pb[n])[above].abs().max()) / cfg.lr)
                    tol = torch.where(above, UPDATE_REL * cfg.lr, 2 * cfg.lr)
                else:
                    tol = torch.where(grad.abs() > 1e-5, 2e-6, 2 * cfg.lr)
                excess = float(((p - pb[n]).abs() - tol).max())
                worst_gap = max(worst_gap, excess)
                if not excess <= 0.0:
                    raise AssertionError(f"step {k}: {n} differs beyond the Adam tolerance "
                                         f"by {excess}")
    captured = graph["chunk_fn"].captured
    report = {"steps": steps, "first_step_draws": first_draws, "loss_rel_worst": worst_loss,
              "param_excess_over_tolerance": worst_gap}
    if bf16:
        report.update(grad_rel_worst=worst_grad, update_gap_over_lr_above_gap=worst_update,
                      entries_above_gap=tight)
    if on_card:
        want = {n: c for n, c in per_step.items() if c}
        launches = captured_launches(captured)
        if launches != want:
            raise AssertionError(f"captured launches {launches}, expected {want}")
        report["captured_launches"] = launches
    return report, captured


def captured_launches(captured) -> dict:
    """The kernel launches that each replay of ``captured`` (a
    :class:`CapturedStep`) adds, by wrapper."""
    return {name.removesuffix(".launches"): n for name, n in captured.counts.items()
            if name.endswith(".launches")}


def replay_profile(captured, per_step, n=5, bf16=False) -> dict:
    """``n`` replays under ``torch.profiler``: the step breakdown of
    :func:`profile_steps`, from the records of each kernel the graph ran,
    and each training kernel's launches a replay, which must be
    ``per_step``'s; with ``bf16``, every launch of a kernel templated on the
    element type (the leaf, gather-mean and LSTM cell kernels) must be its
    bf16 instantiation."""
    wall_ms, kernels = profiled_kernels(captured.replay, n)
    report = step_breakdown(wall_ms, kernels, n)
    pats = {**REPLAY_KERNELS, **LSTM_CELL_KERNELS, **PRED_TOWER_KERNELS}

    def launches(extra=""):
        return {name: -(-sum(c for key, c, _ in kernels if pats[name] in key and extra in key)
                        // n) for name in per_step}

    seen = launches()
    if seen != per_step:
        raise AssertionError(f"the replayed step ran {seen}, expected {per_step}")
    report["kernel_launches_per_replay"] = seen
    if bf16:
        in_bf16 = launches("__nv_bfloat16")  # the profiler gives demangled names
        templated = {name: c for name, c in per_step.items() if name != "pool_membership_mask"}
        if any(in_bf16[name] != c for name, c in templated.items()):
            raise AssertionError(f"the bf16 step's bf16 launches {in_bf16}, expected {templated}")
        report["bf16_kernel_launches_per_replay"] = {name: in_bf16[name] for name in templated}
    return report


@contextlib.contextmanager
def timed_replays(tap=None, keep_steps=False):
    """While active, each replay of a :class:`CapturedStep` is timed between
    CUDA events (``"events"``: (a training step?, start, end)); with
    ``keep_steps``, every step made is kept (``"steps"``); with a
    :class:`GatherTap`, the tap's launches of each capture are added back at
    each replay."""
    from gnn_recsys_tpu_torch.train import graph_step

    init, replay = graph_step.CapturedStep.__init__, graph_step.CapturedStep.replay
    record = {"steps": [], "events": []}

    def counted_init(step, *args, **kwargs):  # the tap's launches of the capture
        init(step, *args, **kwargs)
        step.tap_launches = tap.take_graph() if tap else {}
        if keep_steps:
            record["steps"].append(step)

    def timed_replay(step):
        pair = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        pair[0].record()
        replay(step)
        pair[1].record()
        record["events"].append((step.state is not None, *pair))
        if tap:
            tap.replayed(step.tap_launches)

    graph_step.CapturedStep.__init__ = counted_init
    graph_step.CapturedStep.replay = timed_replay
    try:
        yield record
    finally:
        graph_step.CapturedStep.__init__ = init
        graph_step.CapturedStep.replay = replay


def phase_train_graph(dev, data, hidden=256, out=128, steps=200, valid_steps=10,
                      batch_size=2048, pool=2560, fanouts=(8, 4), dedup=False, on_card=True,
                      check_steps=10, dtype=None, random_recall=None, k=10, tap=None,
                      pred="cos") -> dict:
    """The bench step through the trainer's entry point with
    ``MinibatchConfig(device_epoch=True)``: on a card, each step one replay
    of a CUDA graph.  Three epochs of ``steps // 2`` training steps (epoch 0
    is the 10-step loss-only pass) and ``valid_steps`` validation steps each,
    on edge slices of the bench graph.  Reports the steps, edges a second,
    the median training replay (CUDA events), peak memory and the epochs'
    losses (the last training epoch's must be below the first's), and checks
    the launch counts against the steps run (the warm-up steps of each of
    the three captures included).  Then :func:`graph_route_check` and the
    replay's profile (:func:`replay_profile`).  ``dtype``: the model's
    computation dtype (bf16: the bench config of ``bench.py:219-231``); with
    ``random_recall``, the trained model's recall@``k`` must beat it.  With
    a :class:`GatherTap` ``tap`` (a dedup run), the trainer's gather-mean
    calls go through it, which counts their launches by shape, captured ones
    once a replay.  ``pred``: the model's scoring head.  Returns the
    launches."""
    from gnn_recsys_tpu_torch.train import graph_step

    phase = ("train_graph_dedup" if dedup else "train_graph") + (
        "_nn" if pred == "nn" else "") + ("_bf16" if dtype == torch.bfloat16 else "")
    g = data.graph
    kw = dict(medium_kwargs(g, hidden, out), dtype=dtype, pred=pred)
    model = ConvModel(**kw, leaf_kernel=True)
    etypes = tuple(data.train_pairs)
    per_epoch = max(1, steps // 2)
    train_eids = edge_slices(g, etypes, per_epoch * batch_size)
    valid_eids = edge_slices(g, etypes, valid_steps * batch_size,
                             skip={et: len(v) for et, v in train_eids.items()})
    cfg = MinibatchConfig(edge_batch_size=batch_size, fanouts=tuple(fanouts),
                          neg_mode="dense_pool", neg_pool_size=pool, pool_mask_kernel=True,
                          dedup=dedup, num_epochs=3, metrics_every=0, patience=100, seed=0,
                          device_epoch=True)
    per_step = step_counts(g, model, etypes, dedup)
    widths, nb = _per_etype_batch_sizes({et: len(v) for et, v in train_eids.items()}, batch_size)
    nb_valid = _per_etype_batch_sizes({et: len(v) for et, v in valid_eids.items()},
                                      batch_size)[1]
    warm = graph_step.WARMUP_STEPS if on_card else 0
    train_steps = warm + 2 * nb
    eval_steps = warm + min(10, nb) + warm + 3 * nb_valid
    want = {name: n * (train_steps + (0 if name.endswith("_bwd") else eval_steps))
            for name, n in per_step.items()}

    counters = build.launch_counters()
    profiling.reset_counters()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    if tap:
        conv_model.gather_mean, tap.counting = tap, True
    t0 = time.perf_counter()
    try:
        with timed_replays(tap) as replays:
            state, hist = train_minibatch(model, g, g,
                                          {nt: g.ndata[nt]["features"] for nt in g.ntypes},
                                          train_eids, valid_eids, cfg, device=dev)
            sync(dev)
    finally:
        conv_model.gather_mean = gm.gather_mean
        if tap:
            tap.counting = False
    wall_s = time.perf_counter() - t0
    launches = {name: counters[name].launches for name in per_step}
    if on_card and launches != want:
        raise AssertionError(f"{phase}: launches {launches}, expected {want}")
    if tap:
        tap.check_totals(launches, phase)
    losses = hist["train_loss"]
    if not (np.isfinite(losses).all() and np.isfinite(hist["valid_loss"]).all()
            and losses[2] < losses[1]):
        raise AssertionError(f"{phase}: the loss is not finite or does not fall: {losses}")
    report = {"route": "cuda_graph" if on_card else "eager_body", "train_steps": 2 * nb,
              "loss_only_steps": min(10, nb), "valid_steps": 3 * nb_valid,
              "edges_per_step": sum(widths.values()),
              "edges_per_s_train_epochs": hist["edges_per_s"][1:], "wall_s": wall_s,
              "train_loss": losses, "valid_loss": hist["valid_loss"], "updates": state.step,
              "launches": launches, "launches_expected": want, "launches_per_step": per_step}
    if pred == "nn":  # the tower's engagement: its pairs over every pair the head scored
        report.update(tower_pairs=pt.pred_tower.pairs, head_pairs=PredictingLayer.pairs)
        if on_card and not pt.pred_tower.pairs:
            raise AssertionError(f"{phase}: the tower scored no pair")
    if tap:
        report["gather_launches_by_shape"] = {
            name: {"B{}_K{}_N{}_D{}".format(*shape): c for shape, c in by_shape.items()}
            for name, by_shape in tap.launches.items()}
    train_ms = [a.elapsed_time(b) for update, a, b in replays["events"] if update]
    if on_card:
        if len(train_ms) != 2 * nb:
            raise AssertionError(f"{phase}: {len(train_ms)} timed replays, expected {2 * nb}")
        report.update(step_ms_median=float(np.median(train_ms)),
                      step_ms_min=float(np.min(train_ms)), step_ms_max=float(np.max(train_ms)),
                      max_memory_allocated_bytes=torch.cuda.max_memory_allocated(dev))
    if random_recall is not None:  # the trained model's quality against the random weights'
        h = compute_embeddings(model, g, {nt: g.ndata[nt]["features"] for nt in g.ntypes},
                               device=dev)
        metrics = get_metrics_at_k(h["user"], h["item"], data.test_ground_truth,
                                   data.train_pairs[BUYS], k, device=dev)
        report.update(embedding_dtype=str(h["user"].dtype), precision_recall_coverage=metrics,
                      random_weights_recall=random_recall)
        if not metrics[1] > random_recall:
            raise AssertionError(f"{phase}: trained recall@{k} {metrics[1]} <= random "
                                 f"weights' {random_recall}")
    del state, model, hist
    gd = g.to(dev)
    feats = {nt: gd.ndata[nt]["features"] for nt in gd.ntypes}
    tables = {et: build_padded_pair_set(u, i, num_src=data.num_users).to(dev)
              for et, (u, i) in data.train_pairs.items()}
    report["graph_check"], captured = graph_route_check(
        dev, gd, feats, kw, cfg, train_eids, tables, per_step, steps=check_steps,
        on_card=on_card)
    if on_card:
        report["profile"] = replay_profile(captured, per_step, bf16=dtype == torch.bfloat16)
    say(phase, **report)
    return launches


def phase_packed_leaf(dev, data, model, seeds=32) -> None:
    """One tree forward at fanouts (-1, -1) for ``seeds`` users and items
    through the packed leaf cache and without it (same weights): within TOL."""
    g = data.graph.to(dev)
    feats = {nt: g.ndata[nt]["features"] for nt in g.ntypes}
    ids = {"user": torch.arange(seeds, device=dev), "item": torch.arange(seeds, device=dev)}
    fanouts = (-1,) * model.num_conv_layers
    t0 = time.perf_counter()
    packed_graph = attach_leaf_features(g, feats)
    sync(dev)
    attach_s = time.perf_counter() - t0
    model.eval()
    with torch.no_grad():
        draws = Draws(torch.Generator(device=dev).manual_seed(0))
        packed = model.sampled_repr(packed_graph, feats, ids, fanouts, draws)
        plain = model.sampled_repr(g, feats, ids, fanouts, draws)
    err = max(float((packed[nt] - plain[nt]).abs().max()) for nt in ids)
    if not err <= TOL:
        raise AssertionError(f"packed and unpacked leaves differ by {err}")
    cache = sum(r.nbr_feat.numel() * r.nbr_feat.element_size()
                for r in packed_graph.rels.values() if r.nbr_feat is not None)
    say("packed_leaf", seeds=seeds, max_abs_err=err, attach_s=attach_s, cache_bytes=cache)


def popularity_recall(data, k=10) -> float:
    """recall@k of recommending the most bought items to every test user
    (the JAX package's ``tests/test_e2e_fullbatch.py:16-27``)."""
    top = np.argsort(-np.bincount(data.train_pairs[BUYS][1], minlength=data.num_items))[:k]
    gt_u, gt_i = data.test_ground_truth
    users = np.unique(gt_u)
    return recs_to_metrics(np.tile(top, (len(users), 1)), users, gt_u, gt_i, data.num_items)[1]


def full_batch_kwargs(graph, pred, hidden=256, out=128) -> dict:
    """BASELINE config[0] (2-layer mean GraphSAGE) at the Medium width."""
    return dict(medium_kwargs(graph, hidden, out), aggregator_type="mean", pred=pred)


def grad_gap(a: dict, b: dict) -> tuple:
    """The largest ``|a - b|`` of any parameter's gradient relative to that
    parameter's largest entry in ``b``, and the parameter."""
    return max((float((a[n] - g).abs().max() / g.abs().max().clamp(min=1e-30)), n)
               for n, g in b.items())


def full_batch_step_check(dev, pred, hidden, out, size, cfg) -> dict:
    """One full-batch step on ``dev`` against the same step on the CPU, from
    one state with the card's negatives replayed: the loss within LOSS_RTOL,
    the parameters after Adam's update within 2e-6 where |g| > 1e-5 and
    2 * lr elsewhere, and the gradients within FULL_BATCH_GRAD_REL of each
    parameter's largest entry.  Adam's first update moves a weight by about
    lr * sign(g), so the gradients are held in their own right.  Two more
    steps witness where the gap comes from: the step in f64 on the CPU,
    which the card's gradients must meet within FULL_BATCH_F64_GRAD_REL (the
    CPU's own f32 gap to it is reported), and the card's step run again (its
    ``index_add_`` adds with atomics, in no fixed order).  ``size``: the
    graph's (users, items)."""
    data = bench_data(*size)
    kw = full_batch_kwargs(data.graph, pred, hidden, out)
    first = ConvModel(**kw)
    init_model(first, seed=1)
    recorded = Draws(torch.Generator(device=dev).manual_seed(3), record=True)
    cpu = torch.device("cpu")
    results = {}
    for run, d, dtype in (("card", dev, torch.float32), ("card_again", dev, torch.float32),
                          ("cpu", cpu, torch.float32), ("cpu_f64", cpu, torch.float64)):
        m = ConvModel(**kw)
        m.load_state_dict(first.state_dict())
        m = m.to(d, dtype)
        draws = recorded if run == "card" else ReplayDraws(
            [], [x.to(d) for x in recorded.randints])
        step = make_full_batch_step(m, cfg, tuple(data.train_pairs))
        feats = {nt: data.graph.ndata[nt]["features"].to(dtype) for nt in data.graph.ntypes}
        _, loss = step(TrainState.create(m, lr=cfg.lr),
                       *full_batch_inputs(data.graph, data.graph, feats, data.train_pairs, d),
                       draws)
        results[run] = (float(loss), {n: p.grad.double().cpu() for n, p in m.named_parameters()},
                        {n: p.detach().float().cpu() for n, p in m.named_parameters()})
    (lc, card, card_p), (lp, cpu_g, cpu_p) = results["card"], results["cpu"]
    if not abs(lc - lp) <= LOSS_RTOL * abs(lp):
        raise AssertionError(f"full-batch step, card vs CPU: loss {lc} vs {lp}")
    gaps = {"card_vs_cpu": grad_gap(card, cpu_g),
            "card_vs_card_again": grad_gap(card, results["card_again"][1]),
            "card_vs_cpu_f64": grad_gap(card, results["cpu_f64"][1]),
            "cpu_vs_cpu_f64": grad_gap(cpu_g, results["cpu_f64"][1])}
    for what, bound in (("card_vs_cpu", FULL_BATCH_GRAD_REL),
                        ("card_vs_cpu_f64", FULL_BATCH_F64_GRAD_REL)):
        if not gaps[what][0] <= bound:
            raise AssertionError(f"full-batch step, {what}: gradients of {gaps[what][1]} "
                                 f"apart by {gaps[what][0]} of the largest entry")
    update_gap = 0.0
    for name, g in cpu_g.items():
        gap = (card_p[name] - cpu_p[name]).abs()
        big = g.abs() > 1e-5
        big_gap = float(gap[big].max()) if big.any() else 0.0
        if not (big_gap <= 2e-6 and float(gap.max()) <= 2 * cfg.lr):
            raise AssertionError(f"full-batch step, card vs CPU: {name} updated apart")
        update_gap = max(update_gap, big_gap)
    return {"users_items": list(size), "loss_card": lc, "loss_cpu": lp,
            "loss_cpu_f64": results["cpu_f64"][0],
            "grad_gap_of_largest": {w: v for w, (v, _) in gaps.items()},
            "grad_gap_parameter": {w: n for w, (_, n) in gaps.items()},
            "update_gap_where_g_big": update_gap}


def eval_routes_check(dev, h, ground_truth, already_bought, k, popularity=None,
                      weight=1.0) -> dict:
    """Embeddings ``h`` ranked as the evaluation ranks them
    (``get_metrics_at_k``'s users, the users of the ``ground_truth`` pairs;
    its already-bought table, of the ``already_bought`` pairs; and k; with
    ``popularity``, the boost at ``weight``), through the kernels
    (``mips_topk``, or ``mips_lse`` then ``mips_boost``) and through the
    torch route: rows may differ only at near-ties
    (:func:`_assert_routes_agree`)."""
    gt_u = np.asarray(ground_truth[0])
    bu, bi = already_bought
    uids = torch.as_tensor(np.unique(gt_u), device=dev)
    ps = build_padded_pair_set(bu, bi, num_src=max(h["user"].shape[0], int(np.max(bu)) + 1,
                                                   int(gt_u.max()) + 1))
    route_kw = dict(already_bought=ps, device=dev, popularity=popularity,
                    weight_popularity=weight)
    a, b = (get_recs(h["user"], h["item"], uids, k, backend=route, **route_kw)
            for route in ("cuda", "torch"))
    ue, ie = l2_normalize(h["user"].to(dev)), l2_normalize(h["item"].to(dev))
    cos = dot_scores(ue, ie)
    if popularity is not None:
        pop = torch.as_tensor(popularity).to(dev).reshape(-1).double()
        lse = torch.logsumexp(ue[uids].double() @ ie.double().T, dim=1)

    def score(r, items):
        items = items[items >= 0]
        s = cos(uids[r].expand_as(items), items)
        return s if popularity is None else torch.exp(s - lse[r]) + weight * pop[items]

    gaps = []
    rows = _assert_routes_agree(a, b, score, gaps)
    return {"users": int(uids.numel()), "k": k, "fetch": k + ps.max_row,
            "boosted": popularity is not None, "rows_differing": rows,
            "max_score_gap": max(gaps, default=0.0)}


def serve_nn_run(dev, data, model, kw, users, k) -> dict:
    """``save_run`` the trained nn model, serve one ``inference_ondemand``
    request for ``users`` users on ``dev``, then the same on the CPU: where a
    user's recs differ, the two lists' scores must agree within TOL slot by
    slot, and they may hold other items only where the k-th and (k+1)-th
    unbought scores lie within TOL."""
    report = {}
    rng = np.random.default_rng(5)
    uids = rng.choice(data.num_users, users, replace=False).tolist()
    with tempfile.TemporaryDirectory() as run_dir:
        save_run(run_dir, model.state_dict(), run_model_kwargs(kw), graph=data.graph)
        before = (make_mlp_score_fn.pairs, tm.mlp_topk.pairs, tm.mlp_topk.launches)
        t0 = time.perf_counter()
        card = inference_ondemand(run_dir, uids, k=k, use_popularity=False, device=dev)
        sync(dev)
        report["request_s"] = time.perf_counter() - t0
        head_pairs, kernel_pairs, launched = (
            n - n0 for n, n0 in zip((make_mlp_score_fn.pairs, tm.mlp_topk.pairs,
                                     tm.mlp_topk.launches), before))
        # Engagement: the head's pairs that the kernel ranked (1.0 on the card).
        report.update(head_pairs=head_pairs, mlp_topk_pairs=kernel_pairs,
                      mlp_topk_launches=launched)
        if head_pairs != users * data.num_items or (
                dev.type == "cuda" and (kernel_pairs != head_pairs or launched != 1)):
            raise AssertionError(f"the request's head pairs {head_pairs}, mlp_topk's "
                                 f"{kernel_pairs} in {launched} launches")
        t0 = time.perf_counter()
        load_run(run_dir)
        report["load_run_s"] = time.perf_counter() - t0
        report["load_run_share"] = report["load_run_s"] / report["request_s"]
        cpu = inference_ondemand(run_dir, uids, k=k, use_popularity=False, device="cpu")
    buys_u, buys_i = data.train_pairs[BUYS]
    bought = build_padded_pair_set(buys_u, buys_i, num_src=data.num_users)
    _assert_recs_valid(card, bought.rows.numpy(), data.num_items)
    if sorted(card) != sorted(uids) or any(len(r) != k for r in card.values()):
        raise AssertionError("inference_ondemand answered other users or widths")
    differ = [u for u in uids if card[u] != cpu[u]]
    if differ:
        cpu_model = ConvModel(**kw)
        cpu_model.load_state_dict({n: t.cpu() for n, t in model.state_dict().items()})
        h = compute_embeddings(cpu_model, data.graph, {nt: data.graph.ndata[nt]["features"]
                                                       for nt in data.graph.ntypes})
        rows = torch.as_tensor(differ)
        scores = make_mlp_score_fn(cpu_model)(h["user"][rows], h["item"])
        scores = scores.masked_fill(scatter_row_mask(bought, rows, data.num_items),
                                    float("-inf"))
        ranked = scores.sort(dim=1, descending=True).values
        for r, u in enumerate(differ):
            a, b = (scores[r, torch.as_tensor(x)] for x in (card[u], cpu[u]))
            tied = float(ranked[r, k - 1] - ranked[r, k]) < TOL
            if not (float((a - b).abs().max()) <= TOL
                    and (tied or set(card[u]) == set(cpu[u]))):
                raise AssertionError(f"nn recs of user {u}: card {card[u]} vs CPU {cpu[u]}")
    report.update(users=users, k=k, users_differing_from_cpu=len(differ))
    return report


def phase_train_full_batch(dev, pred="cos", num_users=10_000, num_items=3_000, hidden=256,
                           out=128, epochs=30, eval_every=10, profile_epochs=3, k=10,
                           check_size=(500, 150), serve_users=128, on_card=True) -> dict:
    """Train BASELINE config[0] at the Medium width with ``train_full_batch``
    on the bench generator's graph at ``num_users`` / ``num_items``:
    ``FullBatchConfig`` defaults (63 negatives a positive, delta 0.266, lr
    1e-3), ``epochs`` epochs, evaluating every ``eval_every``.  Reports each
    epoch's step time (``train_full_batch``'s host clock, which ends in
    reading the loss), peak memory, the loss curve, recall@k beside the
    random weights' and the popularity baseline's and the launches of
    ``mips_topk`` (cosine evaluation); with the cosine head,
    :func:`eval_routes_check`; on the card, ``profile_epochs`` steps between
    CUDA events and as many under ``torch.profiler``; then
    :func:`full_batch_step_check`.  With ``pred='nn'`` also
    :func:`serve_nn_run`.  Returns the phase's launch counts."""
    phase = "train_full_batch" + ("_nn" if pred == "nn" else "")
    data = bench_data(num_users, num_items)
    g = data.graph
    kw = full_batch_kwargs(g, pred, hidden, out)
    cfg = FullBatchConfig(num_epochs=epochs, eval_every=eval_every, k=k)
    feats = {nt: g.ndata[nt]["features"] for nt in g.ntypes}
    bought = data.train_pairs[BUYS]
    model = ConvModel(**kw).to(dev)
    init_model(model, seed=cfg.seed)  # train_full_batch's own initial weights
    h = compute_embeddings(model, g, feats, device=dev)
    random_recall = get_metrics_at_k(h["user"], h["item"], data.test_ground_truth, bought, k,
                                     score_fn=model_score_fn(pred, model), device=dev)[1]
    positives = sum(len(u) for u, _ in data.train_pairs.values())
    report = {"users": num_users, "items": num_items, "hidden": hidden, "out": out,
              "positives_per_step": positives,
              "negative_pairs_per_step": positives * cfg.neg_sample_size,
              "random_weights_recall": random_recall,
              "popularity_recall": popularity_recall(data, k)}

    # The main path, through the entry point: counters from 0, read right
    # after.  Each epoch's time is the trainer's own (host clock, up to
    # reading the loss, which waits for the card).
    profiling.reset_counters()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    state, hist = train_full_batch(model, g, g, feats, data.train_pairs, data.test_ground_truth,
                                   cfg, already_bought=bought, device=dev)
    sync(dev)
    report["train_s"] = time.perf_counter() - t0
    launches = {"mips_topk": tm.mips_topk.launches, "mlp_topk": tm.mlp_topk.launches}
    epoch_ms = 1e3 * np.asarray(hist["epoch_time"])
    report.update(epochs=len(hist["loss"]), loss=hist["loss"], recall=hist["recall"],
                  precision=hist["precision"], coverage=hist["coverage"],
                  epoch_ms_median=float(np.median(epoch_ms)), epoch_ms_min=float(epoch_ms.min()),
                  epoch_ms_max=float(epoch_ms.max()), launches=launches)
    if dev.type == "cuda":
        report["max_memory_allocated_bytes"] = torch.cuda.max_memory_allocated(dev)
    losses = np.asarray(hist["loss"])
    if not np.isfinite(losses).all() or not losses[-1] < losses[0]:
        raise AssertionError(f"{phase}: the loss is not finite or does not fall: {losses}")
    if not hist["recall"][-1] > random_recall:
        raise AssertionError(f"{phase}: trained recall@{k} {hist['recall'][-1]} <= random "
                             f"weights' {random_recall}")
    ranker = "mips_topk" if pred == "cos" else "mlp_topk"
    if on_card and not launches[ranker]:
        raise AssertionError(f"{phase}: the {pred} evaluation never launched {ranker}")
    if pred == "cos":
        report["eval_routes"] = eval_routes_check(
            dev, compute_embeddings(model, g, feats, device=dev), data.test_ground_truth,
            data.train_pairs[BUYS], k)
    if on_card:
        step = make_full_batch_step(model, cfg, tuple(data.train_pairs))
        inputs = full_batch_inputs(g, g, feats, data.train_pairs, dev)
        draws = Draws(torch.Generator(device=dev).manual_seed(7))
        report["step_ms_events"] = event_step_ms(lambda: step(state, *inputs, draws),
                                                 n=profile_epochs)
        report["profile"] = profile_steps(lambda: step(state, *inputs, draws), n=profile_epochs)
    report["step_card_vs_cpu"] = full_batch_step_check(dev, pred, hidden, out, check_size, cfg)
    if pred == "nn":
        report["serve"] = serve_nn_run(dev, data, model, kw, serve_users, k)
    say(phase, **report)
    return launches


# Device memory a trial may leave allocated once its objects are dropped
# (the first trial's cuBLAS workspaces on the shared warm-up stream fit in
# it): a trial whose captured graphs and their pools outlived it, or that
# left a workspace a new stream, would exceed it.
TRIAL_LEFTOVER_BYTES = 128 << 20
# The first three proposals of run_search(optimizer="gp", seed=46): the
# defaults (the reference's x0), then the GP optimizer's random asks, which
# do not depend on the objectives.  Floats to 4 digits.
HP_TRIALS = (
    dict(aggregator_type="mean_nn", aggregator_hetero="mean", embed_dim="medium", n_layers=3,
         embedding_layer=False, popularity_importance="no", use_recency=True,
         neg_sample_size=2500, dropout=0.01, delta=0.266),
    dict(aggregator_type="pool_nn", aggregator_hetero="sum", embed_dim="large", n_layers=4,
         embedding_layer=True, popularity_importance="medium", use_recency=False,
         neg_sample_size=2484, dropout=0.4975, delta=0.2045),
    dict(aggregator_type="mean_nn", aggregator_hetero="max", embed_dim="small", n_layers=3,
         embedding_layer=True, popularity_importance="small", use_recency=True,
         neg_sample_size=1597, dropout=0.5843, delta=0.161),
)


def dropout_replay_check(dev, make_model, cfg, graph, feats, tables, eids, n=4, seed=3) -> dict:
    """A trial's training step at its dropout: ``n`` replays of the captured
    step and ``n`` eager runs of its body, each from the same initial
    parameters, Adam state, permutation and step draws (the step's generator
    re-seeded before each).  Only dropout's masks differ: they come from the
    default CUDA generator, which a captured graph advances at each replay.
    Every loss must be finite, the replays' losses must not all be equal
    (new masks each replay), and the replays' mean within 5 standard errors
    of the eager runs' (the masks' spread)."""
    from gnn_recsys_tpu_torch.train import graph_step
    from gnn_recsys_tpu_torch.train.minibatch import _reverse

    etypes = tuple(eids)
    counts = {et: len(v) for et, v in eids.items()}
    has_reverse = {et: _reverse(et) in graph.rels for et in etypes}
    store = device_edge_store(graph, etypes, dev)
    eids_dev = {et: torch.as_tensor(v, dtype=torch.int64, device=dev) for et, v in eids.items()}
    losses = {}
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=".*capturable=True.*")
        for capture in (True, False):
            model = make_model().to(dev)
            state = TrainState.create(model, lr=cfg.lr)
            state.make_capturable()
            perm_fn, chunk_fn = make_epoch_fns(model, cfg, etypes, True, cfg.exclude_batch_edges,
                                               has_reverse, counts, capture=capture)
            gen = torch.Generator(device=dev)
            held = graph_step._snapshot(state)
            out = []
            for _ in range(n):
                graph_step._restore(state, held)
                gen.manual_seed(seed)
                perms = perm_fn(eids_dev, gen)
                _, loss = chunk_fn(state, graph, feats, tables, store, perms, 0, Draws(gen),
                                   n_steps=1)
                out.append(float(loss[0]))
            losses["replays" if capture else "eager"] = out
            del model, state, perm_fn, chunk_fn
    r, e = (np.asarray(losses[key]) for key in ("replays", "eager"))
    se = float(np.sqrt(r.var(ddof=1) / n + e.var(ddof=1) / n))
    gap = abs(float(r.mean() - e.mean()))
    report = {"losses": losses, "mean_gap": gap, "standard_error": se}
    if not (np.isfinite(r).all() and np.isfinite(e).all()):
        raise AssertionError(f"dropout check: a loss is not finite: {losses}")
    if len(set(r.tolist())) < 2:
        raise AssertionError(f"dropout check: every replay drew the same masks: {losses}")
    if not gap <= 5 * se:
        raise AssertionError(f"dropout check: replays' mean loss {r.mean()} is {gap} from the "
                             f"eager runs' {e.mean()}, beyond 5 standard errors ({se})")
    return report


def trial_gather_rows(dev, tap, run, graph, feats, tables, label, timed) -> list:
    """:func:`capture_step_plan`, then both gather-mean kernels at each shape
    of that step's plan against their plain versions (f32, as the trial
    ran; :func:`phase_gather_steps`), rows named ``label(shape)``."""
    capture_step_plan(dev, tap, run, graph, feats, tables)
    return phase_gather_steps(dev, tap, timed=timed, label=label, bf16=False)


def capture_step_plan(dev, tap, run, graph, feats, tables) -> None:
    """One eager step of the device epoch's body (the trial's config, its
    model, the first batch of a permutation; the step updates the model)
    with the block forward's gather-mean calls captured by ``tap``."""
    from gnn_recsys_tpu_torch.train.minibatch import _reverse

    eids = run.split.train_eids
    etypes = tuple(eids)
    has_reverse = {et: _reverse(et) in graph.rels for et in etypes}
    _, chunk_fn = make_epoch_fns(run.model, run.cfg, etypes, True, run.cfg.exclude_batch_edges,
                                 has_reverse, {et: len(v) for et, v in eids.items()},
                                 capture=False)
    perms = {et: torch.as_tensor(v, dtype=torch.int64, device=dev) for et, v in eids.items()}
    state = TrainState.create(run.model, lr=run.cfg.lr)
    tap.capturing = True
    try:
        chunk_fn(state, graph, feats, tables, device_edge_store(graph, etypes, dev), perms, 0,
                 Draws(torch.Generator(device=dev).manual_seed(1)), n_steps=1)
    finally:
        tap.capturing = False


def hp_trial(dev, data, fixed, hyper, popularity, index, on_card=True) -> tuple:
    """Trial ``index`` of the search: ``trial.run_trial_on_graph`` on the
    built graph (the split with ``max_fanout``, see :func:`phase_hp_search`;
    a pool of at most 2048 items; training through the device epochs; recall
    of the test users on the full graph's embeddings, with the popularity
    boost where the trial serves with it), around which this reports the
    seconds of each part, the same model's recall at its initial weights,
    the training replays (CUDA events), the last epoch's edges a second,
    peak memory, and each kernel's launches in training (the gather-mean
    kernels' by shape too, through a :class:`GatherTap`) and in the
    evaluation.  Then it holds the kernels at this trial's shapes against
    their plain versions: the evaluation's ranking through the kernels
    against the torch route (:func:`eval_routes_check`), and, where the
    trial runs the dedup'd block forward, both gather-mean kernels on one
    step's plan (:func:`trial_gather_rows`, rows ``gather_mean_*:hp<index>:
    B…_K…_N…_D…``).  On the card also a profile of 5 training replays and
    :func:`dropout_replay_check`.  Returns (recall, the report, the rows)."""
    g = data.graph
    bought = data.train_pairs[BUYS]
    counters = build.launch_counters()
    report = {"hyper": dataclasses.asdict(hyper)}
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
        report["allocated_bytes_before"] = torch.cuda.memory_allocated(dev)
    tap = GatherTap()
    at, launches = {}, {}

    def on_stage(stage, run):
        at[stage] = time.perf_counter()
        if stage == "built":
            init_model(run.model.to(dev), seed=run.cfg.seed)  # train_minibatch's own weights
            report["initial_weights_recall"] = trial_metrics(
                trial_embeddings(run.model, g, run.features, fixed, dev), run.model,
                data.test_ground_truth, bought, fixed, hyper, popularity, dev)[1]
            tap.counting = True
        elif stage == "trained":
            tap.counting = False
            launches["train"] = {name: fn.launches for name, fn in counters.items() if fn.launches}
        elif stage == "evaluated":
            launches["eval"] = {name: fn.launches for name, fn in counters.items() if fn.launches}
        if stage in ("built", "trained"):
            sync(dev)
            at[stage + "_end"] = time.perf_counter()
            profiling.reset_counters()

    conv_model.gather_mean = tap
    try:
        with timed_replays(tap, keep_steps=on_card) as replays:
            t0 = time.perf_counter()
            result = run_trial_on_graph(data, data.test_ground_truth, bought, fixed, hyper,
                                        popularity=popularity,
                                        neg_pool_size=min(2048, data.num_items),
                                        max_fanout=fixed.max_fanout, device=dev,
                                        on_stage=on_stage)
        if on_card:  # the trial's own peak, before the checks below allocate
            report["max_memory_allocated_bytes"] = torch.cuda.max_memory_allocated(dev)
        run, hist, recall = result.run, result.history, result.recall
        tap.check_totals({name: launches["train"].get(name, 0) for name in GATHER_KERNELS},
                         "hp_search")
        split = run.split
        losses = hist["train_loss"] + hist["valid_loss"]
        if not np.isfinite(losses).all():
            raise AssertionError(f"hp_search: a loss is not finite: {hist}")
        if not 0.0 <= recall <= 1.0:
            raise AssertionError(f"hp_search: recall@{fixed.k} {recall} is not a share")
        report.update(
            split_s=at["split"] - t0, build_s=at["built"] - at["split"],
            train_s=at["trained"] - at["built_end"], evaluate_s=at["evaluated"] - at["trained_end"],
            dedup=run.cfg.dedup,
            fanouts=run.cfg.fanouts, neg_pool_size=run.cfg.neg_pool_size,
            train_edges={"/".join(et): len(v) for et, v in split.train_eids.items()},
            valid_edges={"/".join(et): len(v) for et, v in split.valid_eids.items()},
            train_graph_row_width={"/".join(et): rel.max_fanout
                                   for et, rel in split.train_graph.rels.items()},
            # What run_trial's split, which passes no max_fanout, would give.
            train_graph_row_width_uncapped={
                "/".join(et): -(-int(np.bincount(rel.dst.numpy()).max()) // 8) * 8
                for et, rel in split.train_graph.rels.items()},
            epochs=len(hist["train_loss"]), train_loss=hist["train_loss"],
            valid_loss=hist["valid_loss"], valid_recall=hist["recall"],
            subtrain_recall=hist["subtrain_recall"],
            edges_per_s_last_epoch=hist["edges_per_s"][-1], updates=run.state.step,
            precision_recall_coverage=(result.precision, recall, result.coverage),
            boosted=hyper.serve_with_popularity_boost, train_launches=launches["train"],
            eval_launches=launches["eval"],
            gather_launches_by_shape={name: {trial_label(index, shape): c
                                             for shape, c in by_shape.items()}
                                      for name, by_shape in tap.launches.items()})
        # The kernels at this trial's shapes against their plain versions.
        boost = hyper.serve_with_popularity_boost
        report["eval_routes"] = eval_routes_check(
            dev, run.embeddings, data.test_ground_truth, bought, fixed.k,
            popularity=popularity if boost else None, weight=hyper.weight_popularity)
        gd = split.train_graph.to(dev)
        feats = {nt: x.to(dev) for nt, x in run.features.items()}
        tables = {et: build_padded_pair_set(g.rels[et].src.numpy(), g.rels[et].dst.numpy(),
                                            num_src=data.num_users).to(dev)
                  for et in split.train_eids}
        rows = []
        if run.cfg.dedup:
            rows = trial_gather_rows(dev, tap, run, gd, feats, tables,
                                     lambda shape: trial_label(index, shape), timed=on_card)
            report["gather_max_abs_err"] = {row["name"]: row["max_abs_err"] for row in rows}
        if on_card:
            train_ms = [a.elapsed_time(b) for update, a, b in replays["events"] if update]
            report.update(train_replays=len(train_ms), step_ms_median=float(np.median(train_ms)),
                          step_ms_min=float(np.min(train_ms)),
                          step_ms_max=float(np.max(train_ms)))
            step = next(s for s in replays["steps"] if s.state is not None)
            report["profile"] = profile_steps(step.replay, n=5)

            def make_model():
                fresh = build_model(data, fixed, hyper)
                init_model(fresh, seed=run.cfg.seed)
                return fresh

            report["dropout_check"] = dict(dropout=hyper.dropout, **dropout_replay_check(
                dev, make_model, run.cfg, gd, feats, tables, split.train_eids))
            del step
        replays.clear()
        del run, split, gd, feats, tables, result, hist
        tap.captured.clear()
    finally:
        conv_model.gather_mean = gm.gather_mean
    if dev.type == "cuda":  # what the trial leaves behind, before any gc.collect()
        torch.cuda.synchronize(dev)
        report["allocated_bytes_after"] = after = torch.cuda.memory_allocated(dev)
        if after - report["allocated_bytes_before"] > TRIAL_LEFTOVER_BYTES:
            raise AssertionError(f"hp_search: the trial left {after} bytes allocated, "
                                 f"{report['allocated_bytes_before']} before it")
    return recall, report, rows


def trial_label(index, shape) -> str:
    return "hp{}:B{}_K{}_N{}_D{}".format(index, *shape)


def phase_hp_search(dev, num_users=20_000, num_items=6_000, max_fanout=32,
                    edge_batch_size=2048, on_card=True) -> dict:
    """Three trials of the port's hyperparameter search on the hard synthetic
    world of ``benchmarks/hp_search_hard.py:46-47, 87-90``
    (``make_hard_synthetic_data(20_000, 6_000, seed=0, max_fanout=32)``:
    240,000 edges an etype, 4 etypes, features of width 8):
    ``run_search(fitness, n_calls=3, optimizer="gp", seed=46)`` in a
    temporary directory, ``fitness`` being :func:`hp_trial` with
    ``FixedParams(max_fanout=32, num_epochs=2)`` (the rest the defaults:
    2048 edges a batch, the full sampler, ``valid_size`` 0.05, k = 10,
    cosine).  Cutting ``num_epochs`` from 100 is the one reduction, for the
    script's time limit (``max_fanout`` and ``edge_batch_size`` are smaller
    only in the CPU rehearsal).  The split passes ``max_fanout``, where
    ``run_trial`` does not (its train graph's rows would be uncapped:
    ROADMAP.md queue 3).  The proposals must be :data:`HP_TRIALS`; a second
    ``run_search`` on the same directory must return the same trials without
    calling ``fitness``; ``mips_topk``, ``mips_lse`` and ``mips_boost`` must
    have launched (``topk_kernel``'s three epilogues).  Popularity is each
    item's share of the purchases (``hp_search_hard.py:96-102``).  Returns
    (the launches of each kernel over the three trials, the rows of the
    gather-mean kernels at the trials' own shapes)."""
    t0 = time.perf_counter()
    data = make_hard_synthetic_data(num_users=num_users, num_items=num_items, seed=0,
                                    max_fanout=max_fanout, with_clicks=True)
    deg = np.bincount(data.train_pairs[BUYS][1], minlength=num_items).astype(np.float32)
    popularity = torch.as_tensor(deg / max(float(deg.sum()), 1.0))
    fixed = FixedParams(max_fanout=max_fanout, num_epochs=2, edge_batch_size=edge_batch_size)
    report = {"users": num_users, "items": num_items, "data_s": time.perf_counter() - t0,
              "edges": {"/".join(et): data.graph.num_edges(et)
                        for et in data.graph.canonical_etypes},
              "row_width": {"/".join(et): rel.max_fanout for et, rel in data.graph.rels.items()},
              "popularity_recall": popularity_recall(data, fixed.k), "trials": []}

    rows = []

    def fitness(hyper) -> float:
        index = len(report["trials"]) + 1
        recall, trial, trial_rows = hp_trial(dev, data, fixed, hyper, popularity, index,
                                             on_card=on_card)
        report["trials"].append(trial)
        for row in trial_rows:  # the launches of the training at the row's shape
            kernel, label = row["name"].split(":", 1)
            row["launches"] = trial["gather_launches_by_shape"][kernel].get(label, 0)
            if on_card and not row["launches"]:
                raise AssertionError(f"hp_search: {row['name']} never launched in training")
        rows.extend(trial_rows)
        say("hp_trial", index=index, **trial)
        return recall

    with tempfile.TemporaryDirectory() as logdir:
        t1 = time.perf_counter()
        state = run_search(fitness, n_calls=len(HP_TRIALS), logdir=logdir, optimizer="gp",
                           seed=46)
        report["search_s"] = time.perf_counter() - t1

        def refuse(hyper):
            raise AssertionError("hp_search: the resumed search ran a trial")

        again = run_search(refuse, n_calls=len(HP_TRIALS), logdir=logdir, optimizer="gp",
                           seed=46)
    proposals = [dataclasses.asdict(t.hyper) for t in state.trials]
    if len(proposals) != len(HP_TRIALS):
        raise AssertionError(f"hp_search: {len(proposals)} trials, expected {len(HP_TRIALS)}")
    for got, want in zip(proposals, HP_TRIALS):
        if any(round(got[key], 4) != value if isinstance(value, float) else got[key] != value
               for key, value in want.items()):
            raise AssertionError(f"hp_search: proposal {got}, expected {want}")
    if [dataclasses.asdict(t.hyper) for t in again.trials] != proposals or \
            [t.objective for t in again.trials] != [t.objective for t in state.trials]:
        raise AssertionError("hp_search: the resumed search returned other trials")
    launches = collections.Counter()
    for trial in report["trials"]:
        launches.update(trial["train_launches"])
        launches.update(trial["eval_launches"])
    if on_card and not all(launches[name] for name in ("mips_topk", "mips_lse", "mips_boost")):
        raise AssertionError(f"hp_search: a topk_kernel epilogue never launched: {launches}")
    report.update(objectives=[t.objective for t in state.trials], resumed_trials=len(again.trials),
                  launches=dict(launches))
    say("hp_search", **{k: v for k, v in report.items() if k != "trials"})
    return dict(launches), rows


# The users the drill asks for by name (benchmarks/e2e_drift_cli.py:242).
ETL_NAMED_USERS = ("u7", "u42", "u1234")


def window_rows(df, item_feat) -> dict:
    """Rows of the interaction table ``df`` after each date window of the
    reference's defaults (365 / 30 / 180 days; the drill's
    ``assert_windows_filter``, ``e2e_drift_cli.py:112-149``): each window
    must drop rows."""
    c, fp = ColumnConfig(), FixedParams()

    def n_rows(days_p, days_c, lifespan):
        out = etl.format_dfs(df, df.take([]), item_feat=item_feat, user_feat=Table({c.ctm_id: []}),
                             days_of_purchases=days_p, days_of_clicks=days_c,
                             lifespan_of_items=lifespan, columns=c, **etl.no_sport_tables(c))
        return len(out[0])

    rows = {"rows_full": n_rows(10_000, 10_000, 10_000),
            "rows_purchase_window": n_rows(fp.days_of_purchases, 10_000, 10_000),
            "rows_click_window": n_rows(10_000, fp.days_of_clicks, 10_000),
            "rows_lifespan": n_rows(365, 10_000, fp.lifespan_of_items)}
    if not (rows["rows_purchase_window"] < rows["rows_full"]
            and rows["rows_click_window"] < rows["rows_full"]
            and rows["rows_lifespan"] < rows["rows_purchase_window"]):
        raise AssertionError(f"etl_cli: a date window dropped no row: {rows}")
    return rows


class TrialObserver:
    """Stands in for ``run_trial`` in the CLI modules while the phase runs
    them: it calls the real one with an ``on_stage`` callback and records, a
    trial, the seconds of each ETL stage (``GraphData.seconds``), the
    graph's nodes and edges, the seconds of the split, build, training,
    evaluation and of saving with the in-loop inference evaluation, the
    trial's metrics and each gather-mean kernel's launches by shape in the
    trial.  For the checks after the path it keeps, a trial, what its
    evaluation ranked (``evals``: the embeddings, the test and purchase
    ground truths, the already-bought pairs, and the popularity where the
    trial serves with the boost) and, for each dedup'd trial, one step's
    plan (``plans``): at the ``"trained"`` stage one eager step of the
    trial's body runs on a copy of the trained model with ``tap`` capturing
    its gather-mean calls (a trial that calls ``gather_mean`` must leave a
    plan).  That step is a check's, not the path's: its
    launches are taken off the counters again, and the default generators
    (which its dropout draws from) are put back as they were."""

    def __init__(self, dev, tap):
        self.dev, self.tap, self.trials = dev, tap, []
        self.evals, self.plans = [], []
        self.calls = collections.Counter()

    def wrap(self, run_trial, label):
        def observed(*args, **kwargs):
            self.calls[label] += 1
            name = f"{label}{self.calls[label]}"
            fixed, hyper = args[:2]
            at = {}
            before = {kernel: collections.Counter(c) for kernel, c in self.tap.launches.items()}
            calls_before = collections.Counter(self.tap.calls_by_shape)

            def on_stage(stage, run):
                at[stage] = time.perf_counter()
                if stage == "trained" and run.cfg.dedup:
                    self.capture_plan(name, run)
                elif stage == "evaluated":
                    self.keep_evaluation(name, run, fixed, hyper)
                sync(self.dev)
                at[stage + "_end"] = time.perf_counter()

            t0 = time.perf_counter()
            result = run_trial(*args, on_stage=on_stage, **kwargs)
            by_shape = {kernel: self.tap.launches[kernel] - before[kernel]
                        for kernel in GATHER_KERNELS}
            planned = bool(self.plans) and self.plans[-1]["trial"] == name
            if planned:
                self.plans[-1]["launches"] = by_shape
            elif self.tap.calls_by_shape - calls_before:
                raise AssertionError(f"etl_cli: trial {name} called gather_mean, but no plan "
                                     "was captured")
            run = result.run
            gd = run.graph_data
            g = gd.graph
            etl_s = sum(gd.seconds.values())
            report = {
                "trial": name, "etl_s": gd.seconds, "nodes": gd.num_nodes,
                "edges": {"/".join(et): g.num_edges(et) for et in g.canonical_etypes},
                "split_s": at["split"] - t0 - etl_s, "build_s": at["built"] - at["split_end"],
                "train_s": at["trained"] - at["built_end"],
                "evaluate_s": at["evaluated"] - at["trained_end"],
                "save_and_inference_eval_s": at.get("inference_evaluated", at["evaluated_end"])
                - at["evaluated_end"],
                "dedup": run.cfg.dedup, "fanouts": run.cfg.fanouts,
                "train_graph_row_width": {"/".join(et): rel.max_fanout
                                          for et, rel in run.split.train_graph.rels.items()},
                "epochs": len(result.history["train_loss"]),
                "train_loss": result.history["train_loss"], "updates": run.state.step,
                "precision_recall_coverage": (result.precision, result.recall, result.coverage),
                "recall_purchase": result.recall_purchase,
                "inference_recall": result.inference_recall, "saved_to": result.saved_to,
                "boosted": self.evals[-1]["popularity"] is not None,
                "gather_launches_by_shape": {
                    kernel: {"B{}_K{}_N{}_D{}".format(*shape): n for shape, n in counts.items()}
                    for kernel, counts in by_shape.items()},
                "hyper": dataclasses.asdict(hyper)}
            if not np.isfinite(result.history["train_loss"]).all():
                raise AssertionError(f"etl_cli: trial {name}: a loss is not finite")
            if result.inference_recall is None or not 0.0 <= result.recall <= 1.0:
                raise AssertionError(f"etl_cli: trial {name}: recall {result.recall}, "
                                     f"inference recall {result.inference_recall}")
            self.trials.append(report)
            return result
        return observed

    def keep_evaluation(self, name, run, fixed, hyper) -> None:
        """What ``run_trial_on_graph`` ranked at the ``"evaluated"`` stage."""
        gd = run.graph_data
        item = gd.graph.ndata.get("item", {})
        popularity = None
        if hyper.serve_with_popularity_boost and "popularity" in item:
            popularity = item["popularity"].reshape(-1)
        self.evals.append({
            "trial": name, "k": fixed.k, "weight": hyper.weight_popularity,
            "popularity": popularity, "bought": gd.already_bought,
            "ground_truths": {"test": gd.ground_truth_test,
                              "purchase": gd.ground_truth_purchase_test},
            "h": {nt: x.detach() for nt, x in run.embeddings.items()}})

    def capture_plan(self, name, run) -> None:
        counters = build.launch_counters()
        held = {kernel: fn.launches for kernel, fn in counters.items()}
        g = run.graph_data.graph
        feats = {nt: x.to(self.dev) for nt, x in run.features.items()}
        tables = {et: build_padded_pair_set(g.rels[et].src.numpy(), g.rels[et].dst.numpy(),
                                            num_src=g.num_nodes("user")).to(self.dev)
                  for et in run.split.train_eids}
        counting, self.tap.counting = self.tap.counting, False
        captured, self.tap.captured = self.tap.captured, []
        try:
            with torch.random.fork_rng(devices=[self.dev] if self.dev.type == "cuda" else []):
                capture_step_plan(self.dev, self.tap, dataclasses.replace(
                    run, model=copy.deepcopy(run.model)), run.split.train_graph.to(self.dev),
                    feats, tables)
            if self.tap.captured:  # none where the aggregator is not a mean
                self.plans.append({"trial": name, "calls": self.tap.captured})
        finally:
            self.tap.counting, self.tap.captured = counting, captured
            for kernel, fn in counters.items():
                fn.launches = held[kernel]

    def checks(self, dev, on_card) -> tuple:
        """After the path: each trial's evaluation ranked through the kernels
        and the torch route (:func:`eval_routes_check`, test and purchase
        users, boosted where the trial served with the boost), and both
        gather-mean kernels against their plain versions on each dedup'd
        trial's plan (rows ``gather_mean_*:etl-<trial>:B…_K…_N…_D…``, each
        with the trial's launches at its shape).  Returns (the routes by
        trial, the rows)."""
        routes = {}
        for ev in self.evals:
            routes[ev["trial"]] = {
                users: eval_routes_check(dev, ev["h"], gt, ev["bought"], ev["k"],
                                         popularity=ev["popularity"], weight=ev["weight"])
                for users, gt in ev["ground_truths"].items() if gt is not None and len(gt[0])}
        rows = []
        for plan in self.plans:  # each dedup'd trial whose aggregator is a mean
            self.tap.captured = plan["calls"]
            trial_rows = phase_gather_steps(
                dev, self.tap, timed=on_card, bf16=False,
                label=lambda shape, t=plan["trial"]: "etl-{}:B{}_K{}_N{}_D{}".format(t, *shape))
            for row in trial_rows:
                kernel = row["name"].split(":", 1)[0]
                row["launches"] = plan["launches"][kernel][tuple(row["shape"][x] for x in "BKND")]
                if on_card and not row["launches"]:
                    raise AssertionError(f"etl_cli: {row['name']} never launched on the path")
            rows += trial_rows
        self.tap.captured = []
        return routes, rows


def phase_etl_cli(dev, num_users=3000, num_items=900, n_calls=2, epochs=3,
                  edge_batch_size=1024, named_users=ETL_NAMED_USERS, on_card=True) -> tuple:
    """The JAX package's CLI drill (``benchmarks/e2e_drift_cli.py:166-260``)
    on the port, in process, through each CLI's ``main(argv)`` on ``dev``:
    ``make_drift_logs`` (3,000 users, 900 items, 30 a user over 540 days),
    the date windows' row counts (:func:`window_rows`), the 14-day presplit,
    ``main_hp --n-calls 2 --num-epochs 3 --remove 0.3 --edge-batch-size
    1024`` (each trial ``run_trial`` from the CSV files: the ETL, the split,
    training, evaluation, saving and the in-loop inference evaluation), the
    best hyperparameters to JSON, ``main_train`` for 3 epochs (patience 4,
    1,024 edges a batch), then ``main_inference`` for three named users at
    k = 10 and ``--all`` at k = 5.  Every kernel counter is set to 0 just
    before ``main_hp`` and read after the last request; a
    :class:`TrialObserver` reports each trial (one ``etl_trial`` line).

    Checks: the run directory's artifacts, k external item ids a named user,
    more than half the users under ``--all``; then the saved run's
    embeddings (``extras.pkl``) ranked on its test users through the kernels
    and through the torch route, with the boost where the run serves with
    it (:func:`eval_routes_check`), and :meth:`TrialObserver.checks`: every
    trial's evaluation ranked both ways (boosted where the trial served with
    the boost) and both gather-mean kernels against their plain versions on
    every dedup'd trial's plan (rows ``gather_mean_*:etl-<trial>:
    B…_K…_N…_D…``).  Returns (each kernel's launches on the path, the
    gather-mean rows)."""
    import io

    from gnn_recsys_tpu_torch.cli import main_hp, main_inference, main_train

    device = str(dev)
    report = {"users": num_users, "items": num_items}
    counters = build.launch_counters()
    tap = GatherTap()
    observer = TrialObserver(dev, tap)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        paths, df = make_drift_logs(f"{tmp}/data", num_users=num_users, num_items=num_items)
        report.update(interactions=len(df), logs_s=time.perf_counter() - t0)
        item_feat = read_data(paths["item_feat"])
        report["windows"] = window_rows(df, item_feat)
        train, test = presplit_data(item_feat, df)
        write_csv(train, f"{tmp}/data/train.csv")
        write_csv(test, f"{tmp}/data/test.csv")
        report.update(presplit_rows=(len(train), len(test)),
                      data_s=time.perf_counter() - t0)
        plots = importlib.util.find_spec("matplotlib") is not None
        run_dir, hp_dir = f"{tmp}/models/run1", f"{tmp}/hp"
        os.makedirs(hp_dir)
        named = [arg for u in named_users for arg in ("--user-ids", u)]

        def cli(main, argv):
            out = io.StringIO()
            t = time.perf_counter()
            with contextlib.redirect_stdout(out):
                result = main(argv + ["--device", device])
            sync(dev)
            return result, out.getvalue(), time.perf_counter() - t

        profiling.reset_counters()
        tap.counting = True
        conv_model.gather_mean = tap
        modules = ((main_hp, "hp"), (main_train, "train"))
        real = {mod: mod.run_trial for mod, _ in modules}
        try:
            for mod, label in modules:
                mod.run_trial = observer.wrap(real[mod], label)
            with timed_replays(tap):
                state, _, report["main_hp_s"] = cli(main_hp.main, [
                    "--train-path", f"{tmp}/data/train.csv",
                    "--test-path", f"{tmp}/data/test.csv",
                    "--item-feat-path", paths["item_feat"],
                    "--user-feat-path", paths["user_feat"], "--n-calls", str(n_calls),
                    "--num-epochs", str(epochs), "--remove", "0.3",
                    "--edge-batch-size", str(edge_batch_size), "--logdir", hp_dir,
                    "--result-filepath", f"{hp_dir}/result_log.txt"])
                hyper_json = f"{hp_dir}/best_hyper.json"
                with open(hyper_json, "w") as f:
                    json.dump(dataclasses.asdict(state.best.hyper), f)
                result, _, report["main_train_s"] = cli(main_train.main, [
                    "--interactions-path", paths["interactions"],
                    "--item-feat-path", paths["item_feat"],
                    "--user-feat-path", paths["user_feat"], "--hyper-json", hyper_json,
                    "--num-epochs", str(epochs), "--patience", str(epochs + 1),
                    "--edge-batch-size", str(edge_batch_size), "--out-dir", run_dir,
                    "--result-filepath", f"{tmp}/train_log.txt",
                    "--plots-dir", f"{tmp}/plots" if plots else ""])
                recs, text, report["request_named_s"] = cli(
                    main_inference.main, ["--run-dir", run_dir, *named, "--k", "10"])
                all_recs, all_text, report["request_all_s"] = cli(
                    main_inference.main, ["--run-dir", run_dir, "--all", "--k", "5"])
        finally:
            for mod, _ in modules:
                mod.run_trial = real[mod]
            conv_model.gather_mean = gm.gather_mean
            tap.counting = False
        launches = {name: fn.launches for name, fn in counters.items()}
        tap.check_totals(launches, "etl_cli")
        for trial in observer.trials:
            say("etl_trial", **trial)

        # What the drill asserts.
        artifacts = sorted(os.listdir(run_dir))
        want = ["extras.pkl", "fixed_params.json", "graph.npz", "hyper_params.json",
                "id_maps.pkl", "model.json", "params.npz"]
        if artifacts != want:
            raise AssertionError(f"etl_cli: run directory holds {artifacts}, expected {want}")
        if not os.path.exists(f"{hp_dir}/result_log.txt") or len(state.trials) != n_calls:
            raise AssertionError(f"etl_cli: main_hp ran {len(state.trials)} trials")
        lines = [ln for ln in text.splitlines() if ln.startswith("u")]
        if sorted(recs) != sorted(named_users) or len(lines) != len(named_users) or \
                any(len(items) != 10 or not all(str(i).startswith("it") for i in items)
                    for items in recs.values()):
            raise AssertionError(f"etl_cli: named requests gave {recs}")
        if not len(all_recs) > num_users // 2 or \
                len([ln for ln in all_text.splitlines() if ln.startswith("u")]) != len(all_recs):
            raise AssertionError(f"etl_cli: --all gave {len(all_recs)} users")
        path_kernels = ("mips_topk",) + GATHER_KERNELS
        if any(ev["popularity"] is not None for ev in observer.evals):
            path_kernels += ("mips_lse", "mips_boost")
        if on_card and not all(launches[name] for name in path_kernels):
            raise AssertionError(f"etl_cli: a kernel of the path never launched: {launches}")

        # The kernels at this path's shapes against their plain versions.
        run = load_run(run_dir)
        extras, hyper = run["extras"], HyperParams(**run["hyper_params"])
        h = {"user": torch.as_tensor(extras["user_embeddings"]).to(dev),
             "item": torch.as_tensor(extras["item_embeddings"]).to(dev)}
        popularity = None
        if hyper.serve_with_popularity_boost:
            popularity = run["graph"].ndata["item"]["popularity"].reshape(-1)
        report["routes"] = eval_routes_check(
            dev, h, tuple(np.asarray(a, dtype=np.int64) for a in extras["ground_truth_test"]),
            extras["already_bought"], 10, popularity=popularity,
            weight=hyper.weight_popularity)
        report["trial_routes"], rows = observer.checks(dev, on_card)
    report.update(plots=plots, hp_objectives=[t.objective for t in state.trials],
                  train_recall=result.recall, train_inference_recall=result.inference_recall,
                  named_recs={u: list(v) for u, v in recs.items()}, all_users=len(all_recs),
                  artifacts=artifacts, launches=launches,
                  gather_launches_by_shape={name: {"B{}_K{}_N{}_D{}".format(*shape): c
                                                   for shape, c in by_shape.items()}
                                            for name, by_shape in tap.launches.items()})
    say("etl_cli", **report)
    return launches, rows


# Kernel-name patterns of the step breakdown, first match wins.
# ----------------------------------------------------------------------
# The LSTM aggregators and remat_levels
# ----------------------------------------------------------------------

def lstm_kwargs(graph, agg, dtype, hidden=256, out=128) -> dict:
    """The Medium model of ``medium_kwargs`` with an LSTM aggregator, in
    ``dtype`` (bf16: the bench config of ``bench.py:219-231``)."""
    return dict(medium_kwargs(graph, hidden, out), aggregator_type=agg, dtype=dtype)


def lstm_per_step(graph, etypes, fanouts, dedup: bool) -> dict:
    """Each training kernel's launches in one LSTM step: the pool mask once
    an etype; the leaf kernel (the LSTM leaf does not fold) and the
    gather-mean (the LSTM reads every slot) never; each LSTM cell kernel
    once a cell update (:func:`lstm_slot_steps`)."""
    seeds = sorted({nt for et in etypes for nt in (et[0], et[2])})
    slots = lstm_slot_steps(graph, seeds, fanouts, dedup)
    counts = {name: (len(etypes) if name == "pool_membership_mask" else 0)
              for name in REPLAY_KERNELS}
    return {**counts, **{name: slots for name in LSTM_CELL_KERNELS}}


def lstm_slot_steps(graph, seed_ntypes, fanouts, dedup: bool) -> int:
    """Cell updates of one LSTM forward of ``seed_ntypes``' nodes: a reducer
    call per node set and in-etype, ``fanouts[l - 1]`` slots at level l
    (the top is level ``len(fanouts)``).  On the tree, every in-etype of
    every node of the seeds' trees above the leaves (``_tree_level``); the
    dedup'd block forward, one call per (level, node type of that level's
    table, in-etype), as :func:`block_means` walks them."""
    if dedup:
        ntypes, total = list(seed_ntypes), 0
        for level in range(len(fanouts), 0, -1):
            in_etypes = [et for nt in ntypes for et in graph.canonical_etypes if et[2] == nt]
            total += len(in_etypes) * fanouts[level - 1]
            ntypes += [et[0] for et in in_etypes if et[0] not in ntypes]
        return total

    def tree(nt: str, level: int) -> int:
        if level == 0:
            return 0
        return tree(nt, level - 1) + sum(fanouts[level - 1] + tree(et[0], level - 1)
                                         for et in graph.canonical_etypes if et[2] == nt)

    return sum(tree(nt, len(fanouts)) for nt in seed_ntypes)


def model_recall(dev, model, data, k) -> float:
    """recall@``k`` of ``model``'s full-graph embeddings on the test pairs."""
    g = data.graph
    h = compute_embeddings(model, g, {nt: g.ndata[nt]["features"] for nt in g.ntypes},
                           device=dev)
    return get_metrics_at_k(h["user"], h["item"], data.test_ground_truth,
                            data.train_pairs[BUYS], k, device=dev)[1]


def item_popularity(data) -> torch.Tensor:
    """Each item's purchases over the most any item has, as ``g.ndata["item"]
    ["popularity"]`` (set there when missing): the boost's popularity."""
    g = data.graph
    if "popularity" not in g.ndata["item"]:
        counts = np.bincount(data.train_pairs[BUYS][1], minlength=data.num_items)
        counts = counts.astype(np.float32)
        g.ndata["item"]["popularity"] = torch.from_numpy(counts / counts.max())[:, None]
    return g.ndata["item"]["popularity"]


def serve_run_routes(dev, data, model, kw, users, k) -> dict:
    """``save_run`` the trained model (served in f32, as the JAX package
    serves a run), then one ``inference_ondemand`` request for ``users``
    users plain and one with the popularity boost
    (latency, and its ``load_run`` share); the run's embeddings ranked for
    those users through the kernels and the torch route, plain and boosted,
    which must agree but at near-ties (:func:`eval_routes_check`)."""
    g = data.graph
    pop = item_popularity(data).reshape(-1).to(dev)
    uids = np.random.default_rng(6).choice(data.num_users, users, replace=False)
    report = {"users": users, "k": k}
    with tempfile.TemporaryDirectory() as run_dir:
        # A run's model.json holds no computation dtype: it serves in f32.
        run_kw = run_model_kwargs({key: v for key, v in kw.items() if key != "dtype"})
        save_run(run_dir, model.state_dict(), run_kw, hyper_params=HyperParams(), graph=g)
        t0 = time.perf_counter()
        run = load_run(run_dir)
        report["load_run_s"] = time.perf_counter() - t0
        for boost in (False, True):
            t0 = time.perf_counter()
            recs = inference_ondemand(run_dir, uids.tolist(), k=k, use_popularity=boost,
                                      device=dev)
            sync(dev)
            s = time.perf_counter() - t0
            report["boosted_request_s" if boost else "request_s"] = s
            if sorted(recs) != sorted(uids.tolist()) or any(len(r) != k for r in recs.values()):
                raise AssertionError("inference_ondemand answered other users or widths")
        report["load_run_share"] = report["load_run_s"] / report["request_s"]
    served = ConvModel(**model_kwargs_to_config(run["model_kwargs"]))
    served.load_state_dict(run["params"])
    h = compute_embeddings(served.to(dev), g, {nt: g.ndata[nt]["features"] for nt in g.ntypes},
                           device=dev)
    bought = already_bought_from_graph(g)
    report["routes"] = {("boosted" if p is not None else "plain"):
                        eval_routes_check(dev, h, (uids, None), bought, k, popularity=p)
                        for p in (None, pop)}
    return report


def step_grads_twice(dev, model, cfg, g, feats, tables, eids) -> dict:
    """Two gradient computations of one step from the same parameters,
    batch and draws (the second replays the first's): whether the
    gradients are the same bits, and the largest gap relative to each
    parameter's largest entry (PyTorch's ``index_add_``, the backward of
    the block forward's row takes, adds with atomics on CUDA)."""
    etypes = tuple(eids)
    batch = EdgeStore(g, etypes).batch({et: v[:cfg.edge_batch_size] for et, v in eids.items()},
                                       True, dev)
    loss_fn = make_minibatch_loss(model, cfg, etypes, True, {et: True for et in etypes})
    rec = Draws(torch.Generator(device=dev).manual_seed(2), record=True)
    out = []
    for draws in (rec, None):
        model.train()
        model.zero_grad(set_to_none=True)
        loss = loss_fn(g, feats, batch, tables, draws or rec.replay())
        loss.backward()
        out.append((float(loss.detach()), _grads(model)))
    (la_, ga), (lb, gb) = out
    gaps = {n: float((ga[n] - gb[n]).abs().max()) / max(float(ga[n].abs().max()), 1e-30)
            for n in ga}
    worst = max(gaps, key=gaps.get)
    if la_ != lb or gaps[worst] > STEP_GRAD_RTOL:
        raise AssertionError(f"two steps from one state: loss {la_} vs {lb}, {worst}'s "
                             f"gradients {gaps[worst]} apart")
    return {"bit_identical": all(torch.equal(ga[n], gb[n]) for n in ga),
            "largest_gap_rel": gaps[worst], "largest_gap_param": worst}


def phase_train_lstm(dev, data, phase="train_lstm", agg="lstm", dtype=torch.bfloat16,
                     dedup=False, hidden=256, out=128, steps=40, valid_steps=4,
                     batch_size=2048, pool=2560, fanouts=(8, 4), check_steps=6,
                     serve_users=128, k=10, on_card=True) -> dict:
    """An LSTM model trained with the bench step through ``train_minibatch``
    and its device epochs (each step one replay of a CUDA graph on a card):
    three epochs on edge slices of the bench graph (the 10-step loss-only
    pass, then ``steps // 2`` training steps an epoch, and ``valid_steps``
    validation steps each).  Reports the median training replay (CUDA
    events), edges a second, peak memory, the losses (they must fall), and
    the launches: each pool-mask launch of the steps run (the captures'
    warm-ups included), no leaf or gather-mean launch, and each LSTM cell
    kernel K times a reducer call (the backward's in the training steps
    only); the reducer's own count of its cell updates from the run's start
    (``MaskedLSTMReducer.slot_steps``) must be :func:`lstm_slot_steps` a
    step, which is the forward kernel's launches.  Then
    :func:`graph_route_check` (the eager body against as many replays, at
    the bf16 tolerances for a bf16 model), 5 profiled replays
    (:func:`replay_profile`), recall@``k`` against the same model's random
    weights, which it must beat, and :func:`serve_run_routes`; with
    ``dedup``, :func:`step_grads_twice`.  Returns the launches of the main
    path (training, evaluation and serving) by kernel."""
    from gnn_recsys_tpu_torch.train import graph_step

    g = data.graph
    kw = lstm_kwargs(g, agg, dtype, hidden, out)
    model = ConvModel(**kw)
    etypes = tuple(data.train_pairs)
    per_epoch = max(1, steps // 2)
    train_eids = edge_slices(g, etypes, per_epoch * batch_size)
    valid_eids = edge_slices(g, etypes, valid_steps * batch_size,
                             skip={et: len(v) for et, v in train_eids.items()})
    cfg = MinibatchConfig(edge_batch_size=batch_size, fanouts=tuple(fanouts),
                          neg_mode="dense_pool", neg_pool_size=pool, pool_mask_kernel=True,
                          dedup=dedup, num_epochs=3, metrics_every=0, patience=100, seed=0,
                          device_epoch=True)
    per_step = lstm_per_step(g, etypes, fanouts, dedup)
    widths, nb = _per_etype_batch_sizes({et: len(v) for et, v in train_eids.items()}, batch_size)
    nb_valid = _per_etype_batch_sizes({et: len(v) for et, v in valid_eids.items()},
                                      batch_size)[1]
    warm = graph_step.WARMUP_STEPS if on_card else 0
    train_run = warm + 2 * nb  # the steps that take a backward
    steps_run = train_run + warm + min(10, nb) + warm + 3 * nb_valid
    want = {name: n * (train_run if name == "lstm_cell_bwd" else steps_run)
            for name, n in per_step.items()} if on_card else {name: 0 for name in per_step}
    init_model(model.to(dev), seed=cfg.seed)  # the weights train_minibatch starts from
    random_recall = model_recall(dev, model, data, k)

    counters = build.launch_counters()
    profiling.reset_counters()  # the main path: counters from 0
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    with timed_replays() as replays:
        state, hist = train_minibatch(model, g, g, {nt: g.ndata[nt]["features"] for nt in g.ntypes},
                                      train_eids, valid_eids, cfg, device=dev)
        sync(dev)
    wall_s = time.perf_counter() - t0
    train_launches = {name: counters[name].launches for name in per_step}
    cell_updates = MaskedLSTMReducer.slot_steps
    if cell_updates != per_step["lstm_cell_fwd"] * steps_run:
        raise AssertionError(f"{phase}: {cell_updates} cell updates in {steps_run} steps, "
                             f"expected {per_step['lstm_cell_fwd']} a step")
    if train_launches != want:
        raise AssertionError(f"{phase}: launches {train_launches}, expected {want}")
    losses = hist["train_loss"]
    if not (np.isfinite(losses).all() and np.isfinite(hist["valid_loss"]).all()
            and losses[2] < losses[1]):
        raise AssertionError(f"{phase}: the loss is not finite or does not fall: {losses}")
    report = {"aggregator": agg, "dtype": str(dtype), "dedup": dedup,
              "route": "cuda_graph" if on_card else "eager_body", "train_steps": 2 * nb,
              "loss_only_steps": min(10, nb), "valid_steps": 3 * nb_valid,
              "edges_per_step": sum(widths.values()),
              "edges_per_s_train_epochs": hist["edges_per_s"][1:], "wall_s": wall_s,
              "train_loss": losses, "valid_loss": hist["valid_loss"], "updates": state.step,
              "training_launches": train_launches, "launches_per_step": per_step,
              "cell_updates": cell_updates}
    if on_card:
        train_ms = [a.elapsed_time(b) for update, a, b in replays["events"] if update]
        report.update(step_ms_median=float(np.median(train_ms)),
                      step_ms_min=float(np.min(train_ms)), step_ms_max=float(np.max(train_ms)),
                      max_memory_allocated_bytes=torch.cuda.max_memory_allocated(dev))
    recall = model_recall(dev, model, data, k)
    report.update(recall=recall, random_weights_recall=random_recall)
    if not recall > random_recall:
        raise AssertionError(f"{phase}: trained recall@{k} {recall} <= random weights' "
                             f"{random_recall}")
    report["serve"] = serve_run_routes(dev, data, model, kw, serve_users, k)
    launches = {name: fn.launches for name, fn in counters.items()}
    if on_card and not all(launches[n] for n in ("mips_topk", "mips_lse", "mips_boost")):
        raise AssertionError(f"{phase}: a ranking kernel never launched: {launches}")
    report["launches"] = launches
    del state, hist
    gd = g.to(dev)
    feats = {nt: gd.ndata[nt]["features"] for nt in gd.ntypes}
    tables = {et: build_padded_pair_set(u, i, num_src=data.num_users).to(dev)
              for et, (u, i) in data.train_pairs.items()}
    if dedup:
        report["step_grads_twice"] = step_grads_twice(dev, model, cfg, gd, feats, tables,
                                                      train_eids)
    del model
    report["graph_check"], captured = graph_route_check(
        dev, gd, feats, kw, cfg, train_eids, tables, per_step, steps=check_steps,
        on_card=on_card)
    if on_card:
        report["profile"] = replay_profile(captured, per_step, bf16=dtype == torch.bfloat16)
    say(phase, **report)
    return launches


def phase_remat(dev, data, hidden=256, out=128, batch_size=2048, pool=2560, fanouts=(8, 4),
                replays=10, on_card=True) -> dict:
    """The ``train_lstm`` tree step (bf16 LSTM, the bench config) with
    ``remat_levels`` False and True, each from one initial state and
    permutation and one seed, captured as a CUDA graph (on the CPU: the
    eager body) and replayed: the first replay's loss and gradients of the
    two (the same bits where they are; else each gradient within
    ``BF16_ROUTE_GRAD_REL`` of its parameter's largest entry, the loss
    within ``LOSS_RTOL``: ``index_add_`` adds with atomics), the peak memory
    of each step's capture and replays (remat's must be lower), and both
    replay times.  Then the same pair at dropout 0.5 (the search proposes
    0.5-0.58) for 2 replays, each run after one ``torch.manual_seed``: both
    draw their keep masks through the layers' one dropout, so the same
    checks hold.  Each run counts its cell updates from 0
    (``MaskedLSTMReducer.slot_steps``): :func:`lstm_slot_steps` a step
    without remat, more with it (the backward recomputes the levels); on a
    card the LSTM cell's forward kernel launches once a cell update and its
    backward :func:`lstm_slot_steps` times a step.  Returns the pool mask's
    and the LSTM cell kernels' launches of all four runs."""
    g = data.graph.to(dev)
    feats = {nt: g.ndata[nt]["features"] for nt in g.ntypes}
    etypes = tuple(data.train_pairs)
    eids = edge_slices(g, etypes, replays * batch_size)
    counts = {et: len(v) for et, v in eids.items()}
    store = device_edge_store(g, etypes, dev)
    eids_dev = {et: torch.as_tensor(v, device=dev) for et, v in eids.items()}
    tables = {et: build_padded_pair_set(u, i, num_src=data.num_users).to(dev)
              for et, (u, i) in data.train_pairs.items()}
    cfg = MinibatchConfig(edge_batch_size=batch_size, fanouts=tuple(fanouts),
                          neg_mode="dense_pool", neg_pool_size=pool, pool_mask_kernel=True)
    slots = lstm_per_step(g, etypes, fanouts, dedup=False)["lstm_cell_fwd"]
    warm = WARMUP_STEPS if on_card else 0
    counters = build.launch_counters()
    profiling.reset_counters()

    def run_pair(p: float, n: int) -> dict:
        runs = {}
        for remat in (False, True):
            MaskedLSTMReducer.slot_steps = MaskedLSTMReducer.row_slots = 0
            model = ConvModel(**lstm_kwargs(g, "lstm", torch.bfloat16, hidden, out),
                              dropout=p, remat_levels=remat)
            init_model(model, seed=0)
            model.to(dev)
            state = TrainState.create(model, lr=cfg.lr)
            perm_fn, chunk_fn = make_epoch_fns(model, cfg, etypes, True, True,
                                               {et: True for et in etypes}, counts,
                                               capture=on_card)
            gen = torch.Generator(device=dev).manual_seed(3)
            perms = perm_fn(eids_dev, gen)
            draws = Draws(gen)
            torch.manual_seed(11)  # the keep masks' generators
            if dev.type == "cuda":
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats(dev)
            loss = float(chunk_fn(state, g, feats, tables, store, perms, 0, draws,
                                  n_steps=1)[1][0])
            run = {"loss": loss, "grads": _grads(model)}
            times = []
            for t in range(1, n):
                if dev.type == "cuda":
                    start, end = (torch.cuda.Event(enable_timing=True),
                                  torch.cuda.Event(enable_timing=True))
                    start.record()
                chunk_fn(state, g, feats, tables, store, perms, t, draws, n_steps=1)
                if dev.type == "cuda":
                    end.record()
                    times.append((start, end))
            sync(dev)
            run["cell_updates"] = MaskedLSTMReducer.slot_steps
            if on_card:
                run.update(step_ms_median=float(np.median([a.elapsed_time(b) for a, b in times])),
                           max_memory_allocated_bytes=torch.cuda.max_memory_allocated(dev))
            runs[remat] = run
            del model, state, perm_fn, chunk_fn
        plain, remat = runs[False], runs[True]
        if not (plain["cell_updates"] == slots * (warm + n) < remat["cell_updates"]):
            raise AssertionError(f"remat at dropout {p}: {plain['cell_updates']} cell updates "
                                 f"without, {remat['cell_updates']} with; expected "
                                 f"{slots * (warm + n)} without and more with")
        gaps = {k: float((remat["grads"][k] - g_).abs().max()) / max(float(g_.abs().max()), 1e-30)
                for k, g_ in plain["grads"].items()}
        worst = max(gaps, key=gaps.get)
        if not abs(plain["loss"] - remat["loss"]) <= LOSS_RTOL * abs(plain["loss"]):
            raise AssertionError(f"remat at dropout {p}: loss {remat['loss']} against "
                                 f"{plain['loss']} without")
        if not gaps[worst] <= BF16_ROUTE_GRAD_REL:
            raise AssertionError(f"remat at dropout {p}: {worst}'s gradients {gaps[worst]} apart")
        return {"plain": plain, "remat": remat, "loss": plain["loss"],
                "loss_remat": remat["loss"], "cell_updates": plain["cell_updates"],
                "cell_updates_remat": remat["cell_updates"],
                "bit_identical": plain["loss"] == remat["loss"] and all(
                    torch.equal(remat["grads"][k], g_) for k, g_ in plain["grads"].items()),
                "largest_grad_gap_rel": gaps[worst], "largest_grad_gap_param": worst}

    base = run_pair(0.0, replays)
    drop = run_pair(0.5, 2)
    plain, remat = base.pop("plain"), base.pop("remat")
    launches = {name: counters[name].launches
                for name in ("pool_membership_mask", *LSTM_CELL_KERNELS)}
    if on_card:
        updates = sum(r[k] for r in (base, drop) for k in ("cell_updates", "cell_updates_remat"))
        want = {"lstm_cell_fwd": updates,
                "lstm_cell_bwd": slots * 2 * (warm + replays + warm + 2)}
        if any(launches[name] != n for name, n in want.items()):
            raise AssertionError(f"remat: launches {launches}, expected {want}")
    report = dict(steps=replays, **base,
                  dropout={"p": 0.5, "steps": 2,
                           **{k: v for k, v in drop.items() if k not in ("plain", "remat")}},
                  pool_mask_launches=launches["pool_membership_mask"], launches=launches)
    if on_card:
        report.update({f"{key}{tag}": run[key] for tag, run in (("", plain), ("_remat", remat))
                       for key in ("step_ms_median", "max_memory_allocated_bytes")})
        if not remat["max_memory_allocated_bytes"] < plain["max_memory_allocated_bytes"]:
            raise AssertionError(f"remat: peak memory {remat['max_memory_allocated_bytes']} not "
                                 f"below {plain['max_memory_allocated_bytes']}")
    say("remat", **report)
    return launches


# The kernels the LSTM phases run: the pool mask in every step, the MIPS
# epilogues in each evaluation and served request.
LSTM_ROWS = ("pool_membership_mask", "mips_topk", "mips_lse", "mips_boost")

KERNEL_GROUPS = (
    ("gather_mean_fwd", ("gather_mean_fwd",)),
    ("gather_mean_bwd", ("gather_mean_bwd",)),
    ("leaf_mean_nn", ("leaf_fwd", "leaf_bwd")),
    ("pool_membership_mask", ("pool_mask",)),
    ("matmul", ("gemm", "gemv", "cutlass", "sm90_", "splitK", "nvjet")),
    ("gather / scatter / index", ("index", "gather", "scatter", "Indexing")),
    ("reductions", ("reduce", "Reduce")),
    ("elementwise", ("elementwise", "vectorized", "Elementwise", "unrolled")),
)


# ----------------------------------------------------------------------
# Phase train_sharded: the multi-device training steps
# ----------------------------------------------------------------------
# The training kernels' wrappers, by the names of the kernels line.
def train_counters() -> dict:
    return {"leaf_mean_nn_fwd": la.leaf_mean_nn_fwd, "leaf_mean_nn_bwd": la.leaf_mean_nn_bwd,
            "pool_membership_mask": pm.pool_membership_mask,
            "gather_mean_fwd": gm.gather_mean_fwd, "gather_mean_bwd": gm.gather_mean_bwd}


def zero_counts() -> None:
    profiling.reset_counters()


def read_counts() -> dict:
    return {name: fn.launches for name, fn in train_counters().items()}


def data_mesh(devices) -> Mesh:
    """A ('data',) mesh with one entry a device of ``devices`` (repeats allowed)."""
    return make_mesh(len(devices), data_axis=len(devices), axis_names=("data",),
                     devices=list(devices))


def shard_draws(devices, seed: int, record: bool = False) -> list:
    """One draw source a data shard, seeded ``seed + shard``."""
    return [Draws(torch.Generator(device=d).manual_seed(seed + i), record=record)
            for i, d in enumerate(devices)]


def sharded_world(dev, data, hidden, out, batch_size, pool, fanouts):
    g = data.graph.to(dev)
    feats = {nt: g.ndata[nt]["features"] for nt in g.ntypes}
    kw = medium_kwargs(g, hidden, out)
    etypes = tuple(data.train_pairs)
    tables = {et: build_padded_pair_set(u, i, num_src=data.num_users).to(dev)
              for et, (u, i) in data.train_pairs.items()}
    cfg = MinibatchConfig(edge_batch_size=batch_size, fanouts=tuple(fanouts),
                          neg_mode="dense_pool", neg_pool_size=pool, pool_mask_kernel=True)
    store = EdgeStore(data.graph, etypes)

    def batches():  # epoch after epoch
        rng = np.random.default_rng(0)
        while True:
            yield from iter_edge_batches(rng, {et: np.arange(g.num_edges(et)) for et in etypes},
                                         batch_size)

    return g, feats, kw, etypes, tables, cfg, store, batches()


def fresh_model(dev, kw, **extra) -> ConvModel:
    model = ConvModel(**kw, **extra)
    init_model(model, seed=0)  # the slice phase's random weights
    return model.to(dev)


def grads_of(model) -> dict:
    return {n: p.grad.detach().clone() for n, p in model.named_parameters()}


def check_same_step(what, la_, ga, lb, gb) -> dict:
    """Two steps' losses within LOSS_RTOL and gradients within
    STEP_GRAD_RTOL + STEP_GRAD_ATOL (phase ``train``'s rule)."""
    if not abs(la_ - lb) <= LOSS_RTOL * abs(lb):
        raise AssertionError(f"{what}: loss {la_} vs {lb}")
    worst = 0.0
    for name, a in ga.items():
        excess = ((a - gb[name]).abs() - STEP_GRAD_RTOL * gb[name].abs()).max()
        worst = max(worst, float(excess))
    if not worst <= STEP_GRAD_ATOL:
        raise AssertionError(f"{what}: gradients differ by {worst} beyond rtol {STEP_GRAD_RTOL}")
    return {"loss": la_, "loss_other": lb, "grad_excess_over_rtol": worst}


def dp_timed_run(dev, world, devices, steps, on_card, dtype=torch.bfloat16) -> dict:
    """``steps`` dp steps over a ('data',) mesh of ``devices`` with the leaf
    and pool-mask kernels, each shard's loss and backward one CUDA graph on
    a card: step times, edges a second, peak memory, launches (checked
    against the count from the tree's shape), the loss."""
    g, feats, kw, etypes, tables, cfg, store, batches = world
    model = fresh_model(dev, kw, leaf_kernel=True, dtype=dtype)
    state = TrainState.create(model, lr=cfg.lr)
    mesh = data_mesh(devices)
    step = make_shardmap_dp_step(model, cfg, etypes, mesh)
    draws = shard_draws(mesh.shard_devices("data"), 10)
    if dev.type == "cuda":
        for d in dict.fromkeys(devices):
            torch.cuda.reset_peak_memory_stats(d)
    zero_counts()
    losses, events = [], []
    t0 = time.perf_counter()
    for _ in range(steps):
        if dev.type == "cuda":  # the window holds the batch's assembly too
            events.append((torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True)))
            events[-1][0].record()
        batch = store.batch(next(batches), True, dev)
        _, loss = step(state, g, feats, batch, tables, draws)
        if dev.type == "cuda":
            events[-1][1].record()
        losses.append(loss)
    sync_all(devices)
    train_s = time.perf_counter() - t0
    launches = read_counts()
    per_step = step_counts(g, model, etypes, dedup=False)
    warm = WARMUP_STEPS if on_card else 0  # the captures' eager warm-up steps ran too
    for name, n in per_step.items():
        want = len(devices) * n * (steps + warm) if on_card else 0
        if launches[name] != want:
            raise AssertionError(f"dp over {len(devices)}: {name}: {launches[name]} launches, "
                                 f"expected {want}")
    losses = torch.stack(losses).float().cpu().numpy()
    window = max(1, min(10, steps // 5))
    first, last = float(losses[:window].mean()), float(losses[-window:].mean())
    if not np.isfinite(losses).all() or not last < first:
        raise AssertionError(f"dp over {len(devices)}: the loss does not fall: {first} -> {last}")
    edges = sum(len(v["u"]) for v in batch.values())
    out = {"shards": len(devices), "steps": steps, "edges_per_step": edges,
           "edges_per_s_with_capture": steps * edges / train_s, "loss_first_mean": first,
           "loss_last_mean": last, "launches": launches,
           "launches_per_step_per_shard": per_step}
    if events:
        # The first step captures the shards' graphs; the rate is the rest's.
        ms = [a.elapsed_time(b) for a, b in events]
        out.update(step_ms_median=float(np.median(ms)), step_ms_min=float(np.min(ms)),
                   step_ms_max=float(np.max(ms)), step_ms_first=ms[0],
                   edges_per_s=(steps - 1) * edges / (sum(ms[1:]) / 1e3),
                   max_memory_allocated_bytes=max(torch.cuda.max_memory_allocated(d)
                                                  for d in dict.fromkeys(devices)))
    return out


def dp_route_checks(dev, world, shards=2) -> dict:
    """One f32 step of the dp step through the kernels against the same step
    through their plain versions (the model without the leaf kernel, the
    config without the pool-mask kernel), on the same recorded draws; then
    the dedup'd forward through the dp step, its gather-means through a
    :class:`GatherTap` (launches counted per shard), against the tap's plain
    route."""
    g, feats, kw, etypes, tables, cfg, store, batches = world
    devices = [dev] * shards
    mesh = data_mesh(devices)
    batch = store.batch(next(batches), True, dev)
    runs = {}
    for name, leaf, c in (("kernels", True, cfg),
                          ("plain", False, dataclasses.replace(cfg, pool_mask_kernel=False))):
        model = fresh_model(dev, kw, leaf_kernel=leaf)
        step = make_shardmap_dp_step(model, c, etypes, mesh, capture=False)
        if name == "kernels":
            draws = shard_draws(devices, 7, record=True)
            zero_counts()
        else:
            draws = [d.replay() for d in rec]
        _, loss = step(TrainState.create(model, lr=c.lr), g, feats, batch, tables, draws)
        if name == "kernels":
            rec, counts = draws, read_counts()
        runs[name] = (float(loss), grads_of(model))
    per_step = step_counts(g, model, etypes, dedup=False)
    for kname in ("leaf_mean_nn_fwd", "leaf_mean_nn_bwd", "pool_membership_mask"):
        if dev.type == "cuda" and counts[kname] != shards * per_step[kname]:
            raise AssertionError(f"dp check: {kname} {counts[kname]} launches")
    out = {"kernels_vs_plain": check_same_step("dp step, kernels vs plain", *runs["kernels"],
                                               *runs["plain"]),
           "kernel_check_launches": {k: counts[k] for k in per_step}}

    tap = GatherTap()
    conv_model.gather_mean = tap
    try:
        cfg_d = dataclasses.replace(cfg, dedup=True)
        runs = {}
        for name in ("kernels", "plain"):
            model = fresh_model(dev, kw)
            step = make_shardmap_dp_step(model, cfg_d, etypes, mesh, capture=False)
            if name == "kernels":
                draws = shard_draws(devices, 8, record=True)
                zero_counts()
                tap.counting = True
            else:
                draws = [d.replay() for d in rec]
                tap.fn = plain_gather_mean
            _, loss = step(TrainState.create(model, lr=cfg.lr), g, feats, batch, tables, draws)
            if name == "kernels":
                tap.counting = False
                rec, counts = draws, read_counts()
            runs[name] = (float(loss), grads_of(model))
        means = block_means(g, ("user", "item"), model.num_conv_layers)
        for kname in GATHER_KERNELS:
            want = shards * means if dev.type == "cuda" else 0
            if counts[kname] != want:
                raise AssertionError(f"dedup dp check: {kname} {counts[kname]} launches, "
                                     f"expected {want}")
        out["dedup_vs_plain_gather"] = check_same_step("dedup dp step, kernels vs plain",
                                                       *runs["kernels"], *runs["plain"])
        out["dedup_launches"] = {k: counts[k] for k in GATHER_KERNELS}
        out["dedup_calls_by_shape"] = {str(k): v for k, v in tap.calls_by_shape.items()}
    finally:
        conv_model.gather_mean = gm.gather_mean
    return out


def tp_dp_phase(dev, world, steps, on_card, adj_capacity=2560) -> dict:
    """The ('data' 2, 'model' 2) step on ``dev``: the item table hash-sharded,
    a capacity factor of 2.0, the tensor-parallel leaf, and the
    item-destination relations' adjacency sharded with ``adj_capacity``.
    One f32 step against the dp step on the same draws; then ``steps`` bf16
    steps, timed, with their drops and exchange bytes."""
    g, feats, kw, etypes, tables, cfg, store, batches = world
    mesh = make_mesh(4, data_axis=2, devices=[dev] * 4)
    item_etypes = tuple(et for et in g.canonical_etypes if et[2] == "item")
    hashed, log = hash_shard_table(feats["item"], 2)
    feats_h = dict(feats, item=hashed)
    adj = shard_adjacency(g, item_etypes, 2)
    g_strip = strip_adjacency(g, item_etypes)

    def tp_step(model):
        return make_shardmap_tp_dp_step(model, cfg, etypes, mesh, row_shard_ntypes=("item",),
                                        a2a_capacity_factor=2.0, hash_mix_logs={"item": log},
                                        tp_transform=True, graph_shard_etypes=item_etypes,
                                        adj_capacity=adj_capacity)

    batch = store.batch(next(batches), True, dev)
    dp_model = fresh_model(dev, kw, leaf_kernel=True)
    dp = make_shardmap_dp_step(dp_model, cfg, etypes, data_mesh([dev] * 2), capture=False)
    rec = shard_draws([dev] * 2, 9, record=True)
    _, dp_loss = dp(TrainState.create(dp_model, lr=cfg.lr), g, feats, batch, tables, rec)
    tp_model = fresh_model(dev, kw, leaf_kernel=True)
    tp = tp_step(tp_model)
    _, tp_loss, dropped = tp(TrainState.create(tp_model, lr=cfg.lr), g_strip, feats_h, batch,
                             tables, adj, [d.replay() for d in rec])
    drops = {k: int(v) for k, v in tp.drops.items()}
    if int(dropped) or any(drops.values()):
        raise AssertionError(f"tp-dp step lost ids: {drops}")
    out = {"f32_vs_dp": check_same_step("tp-dp step vs dp step", float(tp_loss),
                                        grads_of(tp_model), float(dp_loss), grads_of(dp_model)),
           "drops_f32_step": drops, "exchange_bytes_per_step": dict(tp.exchange_bytes),
           "adj_capacity": adj_capacity, "capacity_factor": 2.0, "n2_log": log}

    model = fresh_model(dev, kw, leaf_kernel=True, dtype=torch.bfloat16)
    state = TrainState.create(model, lr=cfg.lr)
    step = tp_step(model)
    draws = shard_draws([dev] * 2, 20)
    zero_counts()
    losses, events, lost = [], [], []
    for _ in range(steps):
        if dev.type == "cuda":
            events.append((torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True)))
            events[-1][0].record()
        batch = store.batch(next(batches), True, dev)
        _, loss, dropped = step(state, g_strip, feats_h, batch, tables, adj, draws)
        if dev.type == "cuda":
            events[-1][1].record()
        losses.append(loss)
        lost.append(dropped)
    sync(dev)
    launches = read_counts()
    if int(torch.stack(lost).sum()):
        raise AssertionError("tp-dp bf16 steps lost ids")
    # The lookup hook bypasses the leaf kernel (as in the JAX package); the
    # pool mask runs once an etype a data shard.
    want = {"leaf_mean_nn_fwd": 0, "leaf_mean_nn_bwd": 0,
            "pool_membership_mask": 2 * len(etypes) * steps if on_card else 0}
    for name, n in want.items():
        if launches[name] != n:
            raise AssertionError(f"tp-dp: {name}: {launches[name]} launches, expected {n}")
    losses = torch.stack(losses).float().cpu().numpy()
    if not np.isfinite(losses).all():
        raise AssertionError("tp-dp bf16 loss not finite")
    out.update(bf16_steps=steps, launches=launches, loss_first=float(losses[0]),
               loss_last=float(losses[-1]), exchange_bytes_bf16_step=dict(step.exchange_bytes))
    if events:
        ms = [a.elapsed_time(b) for a, b in events]
        out.update(step_ms_median=float(np.median(ms)), step_ms_min=float(np.min(ms)))
    return out


def mesh_training_check(dev, data, world, epoch_steps=20) -> dict:
    """``train_minibatch(mesh=(2, 2), row_shard_ntypes=("item",))`` through the
    device epochs, cut in depth (the 10-step loss-only epoch 0, then one
    epoch of about ``epoch_steps`` steps), against the replicated run."""
    g, feats, kw, etypes, tables, cfg, store, batches = world
    mesh = make_mesh(4, data_axis=2, devices=[dev] * 4)
    eids = edge_slices(g, etypes, epoch_steps * cfg.edge_batch_size)
    c = dataclasses.replace(cfg, pool_mask_kernel=False, num_epochs=2, metrics_every=0,
                            patience=100)
    runs = {}
    for name, rows in (("row_sharded", ("item",)), ("replicated", ())):
        model = fresh_model(dev, kw)
        t0 = time.perf_counter()
        _, hist = train_minibatch(model, g, g, feats, eids, None, c, mesh=mesh,
                                  row_shard_ntypes=rows)
        sync(dev)
        runs[name] = (hist, model, time.perf_counter() - t0)
    (ha, ma, sa), (hb, mb, sb) = runs["row_sharded"], runs["replicated"]
    la_, lb = np.asarray(ha["train_loss"]), np.asarray(hb["train_loss"])
    if not (np.isfinite(la_).all() and np.allclose(la_, lb, rtol=1e-4, atol=1e-6)):
        raise AssertionError(f"row-sharded losses {la_} vs replicated {lb}")
    worst = 0.0
    for (n, p), q in zip(ma.named_parameters(), mb.parameters()):
        excess = ((p - q).detach().abs() - 2e-4 * q.detach().abs()).max()
        worst = max(worst, float(excess))
    if not worst <= 2e-5:
        raise AssertionError(f"row-sharded parameters differ by {worst} beyond rtol 2e-4")
    return {"epochs": 2, "train_loss_row_sharded": la_.tolist(),
            "train_loss_replicated": lb.tolist(), "param_excess_over_rtol": worst,
            "seconds": {"row_sharded": sa, "replicated": sb},
            "edges_per_s_epoch1": {"row_sharded": ha["edges_per_s"][-1],
                                   "replicated": hb["edges_per_s"][-1]}}


DP_WORKER_SEED = 40
SHARDED_SHAPES = (256, 128, 2048, 2560, (8, 4))  # hidden, out, batch, pool, fanouts


def dp_worker_step(dev, data, mesh, hidden, out, batch_size, pool, fanouts) -> float:
    """One f32 dp step with the kernels over ``mesh`` (a process's local
    entries), the first bench batch, draws seeded ``DP_WORKER_SEED + shard``
    (global shard index): the loss."""
    world = sharded_world(dev, data, hidden, out, batch_size, pool, fanouts)
    g, feats, kw, etypes, tables, cfg, store, batches = world
    model = fresh_model(dev, kw, leaf_kernel=True)
    step = make_shardmap_dp_step(model, cfg, etypes, mesh, capture=False)
    first = distributed.first_shard(mesh, "data")
    draws = [Draws(torch.Generator(device=d).manual_seed(DP_WORKER_SEED + first + i))
             for i, d in enumerate(mesh.shard_devices("data"))]
    _, loss = step(TrainState.create(model, lr=cfg.lr), g, feats,
                   store.batch(next(batches), True, dev), tables, draws)
    return float(loss)


def dp_worker(argv) -> int:
    """``chip_smoke.py --dp-worker PORT RANK BACKEND``: one of two processes
    of phase ``train_sharded``'s two-process check (one card a process
    with NCCL, the shared first card with gloo)."""
    port, rank, backend = argv[0], int(argv[1]), argv[2]
    dev = torch.device("cuda", rank if backend == "nccl" else 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    distributed.initialize_multihost(f"127.0.0.1:{port}", 2, rank, backend=backend,
                                     timeout_s=300)
    mesh = distributed.global_mesh(axis_names=("data",), devices=[dev])
    loss = dp_worker_step(dev, bench_data(), mesh, *SHARDED_SHAPES)
    print(f"BACKEND {mesh.backend}", flush=True)
    print(f"LOSS {loss!r}", flush=True)
    torch.distributed.destroy_process_group()
    return 0


def two_process_check(dev, data) -> dict:
    """The dp step over two processes: NCCL with a card each where the host
    has two, else gloo, both on this card (NCCL refuses two ranks on one
    GPU).  Both losses equal, and equal the one-process step over a mesh of
    two entries on this card with the same draws."""
    backend = "nccl" if torch.cuda.device_count() >= 2 else "gloo"
    with socket.socket() as s:  # a free local port for the group's store
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, os.path.join(here, "chip_smoke.py"),
                               "--dp-worker", str(port), str(r), backend],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              cwd=here) for r in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=600)
            if p.returncode:
                raise AssertionError(f"dp worker failed ({p.returncode}):\n{err[-3000:]}")
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    seconds = time.perf_counter() - t0
    losses = [float(next(line.split()[1] for line in o.splitlines() if line.startswith("LOSS ")))
              for o in outs]
    used = {line.split()[1] for o in outs for line in o.splitlines()
            if line.startswith("BACKEND ")}
    print(f"train_sharded two processes: backend {backend}", flush=True)
    one = dp_worker_step(dev, data, data_mesh([dev] * 2), *SHARDED_SHAPES)
    if used != {backend} or losses[0] != losses[1] or not abs(losses[0] - one) <= \
            LOSS_RTOL * abs(one):
        raise AssertionError(f"two processes ({used}): losses {losses}, one process {one}")
    return {"backend": backend, "losses": losses, "one_process": one, "seconds": seconds}


def cards(n: int) -> list:
    """The first ``n`` cards."""
    return [torch.device("cuda", i) for i in range(n)]


def dp_over_cards(dev, world, steps=10) -> dict:
    """The bf16 dp step over every card (one shard a card), eager and as one
    CUDA graph a shard: each design's wall time a step (host clock, every
    card synced) against the sum of the shards' device times, each shard's
    replay timed alone on its card (CUDA events)."""
    g, feats, kw, etypes, tables, cfg, store, batches = world
    n = torch.cuda.device_count()
    devices = cards(n)
    mesh = data_mesh(devices)
    batch = store.batch(next(batches), True, dev)
    out = {"cards": n}
    for design, capture in (("eager", False), ("cuda_graph_a_shard", True)):
        model = fresh_model(dev, kw, leaf_kernel=True, dtype=torch.bfloat16)
        state = TrainState.create(model, lr=cfg.lr)
        step = make_shardmap_dp_step(model, cfg, etypes, mesh, capture=capture)
        draws = shard_draws(devices, 30)
        for _ in range(3):
            step(state, g, feats, batch, tables, draws)
        walls = []
        for _ in range(steps):
            sync_all(devices)
            t0 = time.perf_counter()
            step(state, g, feats, batch, tables, draws)
            sync_all(devices)
            walls.append((time.perf_counter() - t0) * 1e3)
        out[design] = {"wall_ms_median": float(np.median(walls)),
                       "wall_ms_min": float(np.min(walls))}
        if capture:
            shard_ms = []
            for d, s in zip(devices, step.captured):
                with torch.cuda.device(d):
                    shard_ms.append(time_ms(s.replay, reps=5, warmup=1))
            out["shard_replay_ms"] = shard_ms
    total = sum(out["shard_replay_ms"])
    for design in ("eager", "cuda_graph_a_shard"):
        out[design]["overlapped"] = out[design]["wall_ms_min"] < total
    out["sum_shard_replay_ms"] = total
    return out


def nn_over_cards(dev, world, devices, steps=3) -> dict:
    """The dp step with the MLP head (``pred='nn'``: the tower on each
    shard's dense pool) over ``devices``, a shard each, in one process: in
    f32 and bf16, one eager step against the same step over as many shards
    on ``dev`` (the same seeds, so the same draws; loss and gradients by
    :func:`check_same_step`), then ``steps`` steps with each shard one CUDA
    graph on a card.  Each shard launches the tower's forward and backward
    once an etype (the kernels' shared-memory limit is set in each card's
    context)."""
    g, feats, kw, etypes, tables, cfg, store, batches = world
    batch = store.batch(next(batches), True, dev)
    kw = dict(kw, pred="nn")
    on_card = dev.type == "cuda"
    kernels = (pt.pred_tower_fwd, pt.pred_tower_bwd)
    out = {"shards": len(devices), "devices": [str(d) for d in devices]}
    for dtype, tag in ((None, "f32"), (torch.bfloat16, "bf16")):
        runs, launches = {}, {}
        for name, devs in (("over_devices", devices), ("one_device", [dev] * len(devices))):
            model = fresh_model(dev, kw, leaf_kernel=True, dtype=dtype)
            step = make_shardmap_dp_step(model, cfg, etypes, data_mesh(devs), capture=False)
            zero_counts()
            _, loss = step(TrainState.create(model, lr=cfg.lr), g, feats, batch, tables,
                           shard_draws(devs, 40))
            sync_all(devs)
            launches[name] = [k.launches for k in kernels]
            runs[name] = (float(loss), {n: v.float() for n, v in grads_of(model).items()})
        want = [len(devices) * len(etypes) if on_card else 0] * 2
        if any(n != want for n in launches.values()):
            raise AssertionError(f"nn dp step ({tag}): tower launches {launches}, "
                                 f"expected {want} each")
        report = check_same_step(f"nn dp step ({tag}), over devices vs one",
                                 *runs["over_devices"], *runs["one_device"])
        report["bit_identical"] = runs["over_devices"][0] == runs["one_device"][0] and all(
            torch.equal(v, runs["one_device"][1][n]) for n, v in runs["over_devices"][1].items())
        model = fresh_model(dev, kw, leaf_kernel=True, dtype=dtype)
        state = TrainState.create(model, lr=cfg.lr)
        mesh = data_mesh(devices)
        step = make_shardmap_dp_step(model, cfg, etypes, mesh, capture=on_card)
        draws = shard_draws(mesh.shard_devices("data"), 41)
        zero_counts()
        losses = [float(step(state, g, feats, batch, tables, draws)[1]) for _ in range(steps)]
        sync_all(devices)
        warm = WARMUP_STEPS if on_card else 0  # the captures' eager warm-up steps
        want = len(devices) * len(etypes) * (steps + warm) if on_card else 0
        got = [k.launches for k in kernels]
        if got != [want] * 2 or not np.isfinite(losses).all():
            raise AssertionError(f"nn dp steps ({tag}): tower launches {got}, expected {want}; "
                                 f"losses {losses}")
        report.update(captured_losses=losses, captured_launches=got)
        out[tag] = report
    return out


def phase_train_sharded(dev, data, steps=50, tp_steps=50, on_card=True,
                        shapes=SHARDED_SHAPES, epoch_steps=20, adj_capacity=2560,
                        cards_only=False) -> dict:
    """Phase ``train_sharded``: the multi-device training steps on the bench
    graph and the Medium model at the bench step (``shapes``: hidden 256,
    out 128, 2048 edges a step over every shard, dense pool of 2560 a
    shard, fanouts (8, 4); exclusion, max-margin, Adam).  Returns the main
    path's launches: the dp runs' (bf16 leaf and pool mask) and the dedup'd
    dp check's (gather mean, f32).  On a host with several cards, also the
    dp step over every card and the MLP head's dp step over two
    (:func:`nn_over_cards`).  ``cards_only``: only the two-process check and
    the steps over cards."""
    t_phase = time.perf_counter()
    world = sharded_world(dev, data, *shapes)
    report, launches = {}, {name: 0 for name in train_counters()}
    if cards_only:  # the parts that run across cards, alone
        report["two_processes"] = two_process_check(dev, data)
        report["over_cards"] = dp_over_cards(dev, world)
        report["nn_over_cards"] = nn_over_cards(dev, world, cards(2))
        report["seconds"] = time.perf_counter() - t_phase
        say("train_sharded", **report)
        return launches
    for shards in (1, 2, 4):
        run = dp_timed_run(dev, world, [dev] * shards, steps, on_card)
        report[f"dp_{shards}"] = run
        for name, n in run["launches"].items():
            launches[name] += n
    report["route_checks"] = dp_route_checks(dev, world)
    for name in GATHER_KERNELS:
        launches[name] = report["route_checks"]["dedup_launches"][name]
    report["tp_dp"] = tp_dp_phase(dev, world, tp_steps, on_card, adj_capacity)
    report["train_minibatch_mesh"] = mesh_training_check(dev, data, world, epoch_steps)
    if on_card:
        report["two_processes"] = two_process_check(dev, data)
        if torch.cuda.device_count() > 1:
            report["over_cards"] = dp_over_cards(dev, world)
            report["nn_over_cards"] = nn_over_cards(dev, world, cards(2))
    report["seconds"] = time.perf_counter() - t_phase
    say("train_sharded", **report)
    return launches


def event_step_ms(run_step, n) -> list:
    """Device milliseconds of each of ``n`` steps, between CUDA events."""
    times = []
    for _ in range(n):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        run_step()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    if not all(t > 0 for t in times):
        raise AssertionError(f"a step between CUDA events took no time: {times}")
    return times


def profile_steps(run_step, n=5, top_n=8) -> dict:
    """``n`` steps under ``torch.profiler``: :func:`step_breakdown`."""
    return step_breakdown(*profiled_kernels(run_step, n), n, top_n)


def step_breakdown(wall_ms, kernels, n, top_n=8) -> dict:
    """Host wall time a step, the device's busy time by kernel group (ms a
    step), its idle share, and the ``top_n`` kernels by device time, from a
    profile of ``n`` steps."""
    if not kernels:
        raise RuntimeError("torch.profiler recorded no CUDA kernel for the training steps")
    groups = {name: 0.0 for name, _ in KERNEL_GROUPS}
    groups["other"] = 0.0
    for key, _, us in kernels:
        name = next((g for g, pats in KERNEL_GROUPS if any(p in key for p in pats)), "other")
        groups[name] += us / 1e3 / n
    busy = sum(groups.values())
    top = sorted(kernels, key=lambda kv: -kv[2])[:top_n]
    return {"steps": n, "wall_ms_per_step": wall_ms, "device_busy_ms_per_step": busy,
            "device_idle_share": 1.0 - busy / wall_ms,
            "kernels_per_step": sum(c for _, c, _ in kernels) / n,
            "device_ms_per_step_by_group": groups,
            "top_kernels": [{"name": key[:120], "per_step": c / n, "ms_per_step": us / 1e3 / n}
                            for key, c, us in top]}


def main() -> int:
    kind = phase_device()
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ptxas = phase_build()
    rows = phase_kernels(dev)
    phase_profiler_window(dev, "start")
    t0 = time.perf_counter()
    data = bench_data()
    say("graph", seconds=time.perf_counter() - t0,
        edges={"/".join(et): data.graph.num_edges(et) for et in data.graph.canonical_etypes})
    launches, random_recall = phase_slice(dev, data)
    # Catalog-sharded serving: meshes whose shards share the card, then
    # the cards themselves where there are several.
    sharded_launches = phase_sharded_serving(dev, data)
    # Multi-device training: the dp, tp-dp and mesh steps on the card.
    sharded_train_launches = phase_train_sharded(dev, data)
    train_launches, _ = phase_train(dev, data, random_recall=random_recall)
    launches.update(train_launches)
    # Each kernel's launches are counted on the path that runs it: the
    # gather-mean kernels on the dedup'd step's, by shape too.
    tap = GatherTap()
    dedup_launches, model = phase_train(dev, data, steps=50, tap=tap)
    for name in GATHER_KERNELS:
        launches[name] = dedup_launches[name]
    step_rows = phase_gather_steps(dev, tap)
    rows += step_rows
    phase_packed_leaf(dev, data, model)
    # The device epochs: each step one replay of a CUDA graph.  Then the
    # bench config as bench.py defines it: bf16 compute.  The gather-mean
    # launches by shape are each dedup run's own (0 at a shape it never ran).
    labels = {shape: gather_label(shape) for shape in tap.calls_by_shape}
    for name in GATHER_KERNELS:
        launches.update({f"{name}:{label}": tap.launches[name][shape]
                         for shape, label in labels.items()})
    graph_launches = {}  # f32 in the device epochs; the bf16 runs are the bf16 rows' main path
    for dtype, tag, into in ((None, "", graph_launches), (torch.bfloat16, ":bf16", launches)):
        recall = random_recall if dtype else None
        tree = phase_train_graph(dev, data, dtype=dtype, random_recall=recall)
        run_tap = GatherTap()
        dedup = phase_train_graph(dev, data, steps=50, dedup=True, dtype=dtype, tap=run_tap,
                                  random_recall=recall)
        for name, n in tree.items():
            into[name + tag] = dedup[name] if name in GATHER_KERNELS else n
        for name in GATHER_KERNELS:
            into.update({f"{name}{tag}:{label}": run_tap.launches[name][shape]
                         for shape, label in labels.items()})
    # The MLP head's tower: phase 10's tree step with pred='nn'.
    nn_launches = phase_train_graph(dev, data, dtype=torch.bfloat16, pred="nn")
    for name in PRED_TOWER_KERNELS:
        launches[f"{name}:bf16"] = nn_launches[name]
    # The full-batch trainer (BASELINE config[0]) with each scoring head.
    full_batch_launches = phase_train_full_batch(dev, "cos")
    # The MLP head's evaluations rank through mlp_topk: its row's launches.
    launches["mlp_topk"] = full_batch_launches.pop("mlp_topk") + phase_train_full_batch(
        dev, "nn", num_users=5_000, num_items=1_500, epochs=20)["mlp_topk"]
    # The hyperparameter search: three trials on the hard synthetic world.
    hp_launches, hp_rows = phase_hp_search(dev)
    # The user's path from raw CSV logs: the ETL, run_trial and the CLIs.
    etl_launches, etl_rows = phase_etl_cli(dev)
    # The LSTM aggregators, trained through the device epochs and served;
    # then remat_levels on the LSTM's tree step.
    lstm_launches = {
        "train_lstm": phase_train_lstm(dev, data),
        "train_lstm_edge_dedup": phase_train_lstm(dev, data, phase="train_lstm_edge_dedup",
                                                  agg="lstm_edge", dtype=None, dedup=True)}
    lstm_launches["remat"] = phase_remat(dev, data)
    phase_profiler_window(dev, "end")
    # The LSTM cell's rows: f32 on train_lstm_edge_dedup's path, bf16 on
    # train_lstm's and remat's (their launches by phase below).
    for name in LSTM_CELL_KERNELS:
        launches[name] = lstm_launches["train_lstm_edge_dedup"][name]
        launches[f"{name}:bf16"] = lstm_launches["train_lstm"][name]
    # The full-fanout rows of phase kernels: the drill's launches at K > 32
    # in f32; in bf16, phase 10's (no path runs bf16 at K > 32).
    for row in rows:
        kernel, _, rest = row["name"].partition(":")
        if rest.startswith("wide:"):
            launches[row["name"]] = sum(
                r["launches"] for r in etl_rows
                if r["name"].startswith(kernel + ":") and r["shape"]["K"] > 32)
            if not launches[row["name"]]:
                raise AssertionError(f"{row['name']}: the drill ran no gather at K > 32")
        elif rest.startswith("bf16:wide:"):
            launches[row["name"]] = launches[f"{kernel}:bf16"]
    for row in rows:
        row["launches"] = launches[row["name"]]
        if row["name"] in graph_launches:
            row["graph_launches"] = graph_launches[row["name"]]
        if row["name"] in full_batch_launches:
            row["full_batch_launches"] = full_batch_launches[row["name"]]
        if row["name"] in hp_launches:
            row["hp_search_launches"] = hp_launches[row["name"]]
        if row["name"] in etl_launches:
            row["etl_cli_launches"] = etl_launches[row["name"]]
        if row["name"] in LSTM_ROWS:
            for phase, counts in lstm_launches.items():
                if row["name"] in counts:
                    row[f"{phase}_launches"] = counts[row["name"]]
        kernel, _, tag = row["name"].partition(":")
        if kernel in LSTM_CELL_KERNELS:
            for phase in (("train_lstm", "remat") if tag else ("train_lstm_edge_dedup",)):
                row[f"{phase}_launches"] = lstm_launches[phase][kernel]
        if row["name"] in SHARDED_ROWS:
            row["sharded_serving_launches"] = sharded_launches[row["name"]]
        # The dp runs train in bf16; the dedup'd check runs the f32 gather.
        base = row["name"].removesuffix(":bf16")
        if base in sharded_train_launches and (
                row["name"].endswith(":bf16") == base.startswith("leaf_")):
            row["sharded_train_launches"] = sharded_train_launches[base]
        if row["name"] in ptxas:
            row["ptxas"] = ptxas[row["name"]]
    rows += hp_rows + etl_rows  # launches: each phase's training, by shape
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dp-worker"]:
        sys.exit(dp_worker(sys.argv[2:]))
    sys.exit(main())
