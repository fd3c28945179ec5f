#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`taxoexpan_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises and exits non-zero:

1. device   - requires CUDA; prints the card's name and power limit
              (nvidia-smi) and turns TF32 off for full float32 products.
2. build    - builds every CUDA kernel from taxoexpan_torch/ops/csrc with
              nvcc for sm_90a (one nvcc per source, started together),
              then the native C++ sampler (taxoexpan_torch/native, g++),
              which the loaders' "auto" backend takes in every phase.
3. masks    - the kernels' dropout generator on the card against the
              plain torch generator (ops/dropout.py): the pinned golden
              vectors and 2**20 random (row, column) pairs, bit for bit, for
              the 32-bit words and the 8-bit mode's bytes.
4. kernels  - each kernel against its plain PyTorch version on the card at
              the shapes of configs/config.mag.json (in 250, hidden/out
              500, pos 50; 13 grandparent and 50 sibling slots, N = 64) for
              4096 egonets (one encode chunk, one train step), with random
              ngp/nsib including empty and full egonets. PGAT (heads
              [4, 1]): K1 and K3 in eval form, K1 and K3 in train form
              (feature, pe and attention dropout at the config's 0.1, the
              pe path), K2 (layer 0's backward, need_dx off) and K4 (the
              final layer's backward, need_dx on). PGCN (the same config
              with propagation_method "PGCN"): K5f eval and train form of
              layer 0 (leaky_relu 0.01) and of the final layer, K5b of
              both (need_dx off / on). K7a at the same PGAT shapes: the store
              forms of the K1 and K3 train forms and the stored K2 and K4,
              fed the store forms' softmax weights; their grads also held to
              the recompute backward's on the card (1e-6 of each grad's
              largest value). The SemEval-Verb MTL configuration
              (configs/config.semeval_verb_mtl.json: in 300, hidden 4 x 900,
              out 600, pos 100) at the same B and N: layer 0 (300 + 100 ->
              4 x 900, leaky_relu 0.01) and the per-slot final layer
              (3600 + 100 -> 1 x 600), each as K1 eval, the K1 train store
              form and the stored K2 (need_dx off / on), the train forms
              with 8-bit dropout thresholds (K7b), in float32 and in bf16
              (section 7). The incoming grads of the backwards are drawn on
              the card. Every gradient compared,
              the masks
              regenerated by the plain versions; times of the kernel, its
              plain version and one torch.matmul as a yardstick
              (`matmul_ms`: x @ W for a forward, the dW product x^T @ D for
              a backward; not the layer, so the `library_ms` of the kernels
              line is null), beside the least time the card could take
              (`bound_ms`: the float32 forms' products run on the tensor
              cores in 3xTF32, so at a third of the dense TF32 rate; also
              `bound_fma_ms`, the same work at the float32 FMA rate
              outside the tensor cores, which the kernels beat). Every
              form also gives
              its time by pass (`passes_ms`, CUDA events the kernel library
              records between its launches: staging and packing, the
              projection, the star or pooled star pass; the head core or
              K5b's dz pass, the slot-bias or db sums, dW, dx; the
              forwards of either dtype by their form,
              `gat_kernels.fwd_form`: the fused
              per-slot form's staging, pass A (a1 | a2), the star weights
              and the product with the star pass in its epilogue; the
              pooled valid-rows form's counting and compacted staging of
              the valid rows, the projection on them, the pooled star
              pass; K4's first pass, in either dtype, counts and compacts
              the valid rows). Every GAT forward's entry gives its
              `form`; PGAT's float32 K1, K3, K1t and K3t entries also
              `parent_form`: the two-pass form on the same inputs
              (`gat_kernels.use_form`, the form every float32 forward took
              before the fused and valid-rows forms; it still serves
              N > 64 and the pooled store form) held to the plain version,
              its largest difference from the entry's form, its ms and
              passes. Every GAT form's entry also gives
              `products` (`product_rates`): each product pass's rows (all
              B*N, or K4's valid rows R), TFLOP/s (float32: float32-
              equivalent, three TF32 products on the tensor cores a
              float32 one) and one torch.matmul of its shape in the form's
              dtype (float32 with TF32 off) as a yardstick. The pooled
              star pass of K3 and K5f's star pass are also held alone
              against their plain versions on the projection the card
              computes (`star_alone`).
              The shapes head tensor parallelism over mp = 2 gives the
              star-GAT kernels (mp index 0's shard), in float32 and bf16:
              config.mag.json's layer 0 at 2 of its 4 heads (250 + 50 ->
              2 x 500) as K1 eval, K1t, its store form with the stored K2,
              and K2 (need_dx off), the PGAT-tp path's layer 0; and the
              pooled TP form, K3 eval, K3t and K4 (need_dx on) at 2 of 4
              heads of a pooled layer (2000 + 50 -> 2 x 500), which no
              configuration of the repo reaches (its launches: the pooled
              wrappers' count at 2 heads in the PGAT-tp runs, 0).
              K6 (the halo gather, ops/csrc/halo.cu) in one process
              holding all shards of an 800 x 250 table, at the data-parallel
              path's shapes for P = 2 and P = 4 (one rank's request for its
              share of 4096 egonets x 64 slots, about half the slots past
              the shard), held to its plain version exactly, beside one
              torch.index_select of the same rows (`library_ms`).
              pos_mode "concat" (configs/config.mag.json with the key, paths
              PGAT-concat, PGAT-concat-bf16, PGCN-concat): K1, K1t and K2
              (need_dx on) at layer 0's 250 + 50 = 300 input columns, K3,
              K3t and K4 at the final layer's 2000 + 50 = 2050, in float32
              and bf16 (no slot biases, no pe path, the feature dropout
              over every column); K5f, K5ft and K5b at PGCN's layer 0 (300
              columns, K5b with need_dx on) and final layer (550), float32.
5. serving  - for PGAT, PGCN, then MTL: the port's serving path end to end
              through its entry points: a run directory with a synthetic
              taxonomy (4000 nodes, dim 250; dim 300 for MTL), the
              configuration and the model from random weights (seeded; the
              MTL model's with its auxiliary head's `aux`) in the JAX
              checkpoint format;
              then `taxoexpan_torch.test_fast` (TaxonomyRanker.evaluate,
              the test_fast metrics) and `taxoexpan_torch.infer`
              (predict_parents for 8 novel terms), with the launch counters
              set to 0 just before and read just after. The card's graph
              embeddings are checked against the CPU plain path.
6. training - for PGAT, PGCN, PGAT-stored, then MTL: `python -m
              taxoexpan_torch.train` (its main, in this process) on a run
              directory with a synthetic taxonomy (800 nodes, dim 250: five
              full steps and one padded step of 128 groups x 32 candidates
              = 4096 egonets an epoch; MTL: dim 300, the config's 64 groups
              x 31 candidates) and the configuration at full width with
              full-catalog validation every epoch, for two epochs (one for
              PGAT-stored), the launch counters set to 0 just before and
              read just after, and the run's peak device memory
              (`max_memory_allocated_bytes`, its train steps').
              PGAT-stored is PGAT with
              TAXOEXPAN_STORED_ATTN=1; MTL runs with TAXOEXPAN_STORED_ATTN=1
              and TAXOEXPAN_DROPOUT_BITS=8; the three concat paths run one
              epoch each. Checks a finite loss, changed
              params, the checkpoints (MTL: with `aux`), launches of the
              path's train forms and backwards; serves the best checkpoint
              through `taxoexpan_torch.test_fast`; and holds one train step
              on the card against the same step on the CPU plain path (same
              params, seeds, dropout and switches; 4 groups at full width, 2
              for MTL).
              Then the data-parallel path: `python -m taxoexpan_torch.train`
              as 2 rank processes sharing the card (--coordinator, gloo), at
              config.mag.json's full width on the 800-node taxonomy, 128
              groups a step (64 a rank), one epoch, once with the feature
              table replicated and once row-partitioned with
              TAXOEXPAN_HALO=ring (K6 through CUDA IPC): equal epoch loss
              and final params, bit for bit; each rank reports its launch
              counts (from 0 at its start); rank 0's checkpoint serves
              through test_fast; the 2-rank median step beside the
              single-process PGAT step (two contexts time-slicing one card,
              not a scaling figure).
              Then the tensor-parallel path (PGAT-tp): `python -m
              taxoexpan_torch.train` as 2 rank processes sharing the card
              (gloo) with config.mag.json and "parallel": {"dp": 1, "mp":
              2} at full width (the whole 128-group batch on both ranks,
              layer 0's heads split 2 a rank, the 1-head final layer whole
              on both), one epoch from a start checkpoint, at dropout 0
              against the single-process run from it (epoch loss, final
              params), then at the config's dropout with both ranks'
              profiler windows traced (both ranks' final params equal
              bits); then `test_fast -m` and `infer -m` as 2 rank
              processes against the single process (`phase_tp_training`).
              Then residual GAT layers (`phase_residual`): PGAT-concat with
              its propagation replaced by GAT(residual=True) at the same
              widths (the final layer residual, per slot), its eval encode
              of 4096 egonets and one train step against the plain path on
              the card, launching only the per-slot K1 / K1t / K2. Then one
              epoch of PGAT-concat as 2 rank processes with mp = 2
              (`phase_tp_concat`): every step's grads, pos_emb's and layer
              0's included, against the single process's.
7. bf16    - compute_dtype "bfloat16" (the JAX package's production dtype,
              bench.py:246): in the kernels phase the bf16 forms of K1 (eval
              and train, the pe path), K2 (need_dx off), K3 (eval and
              train), K4 (need_dx on) at PGAT's shapes, and both MTL
              layers' K1 eval, K1t-store and K2-stored (8-bit masks) at
              MTL's shapes (MTL-bf16 is the bf16 path that stores
              attention), and K5's forms at PGCN's shapes (eval, train,
              backward of both layers, x and W_h in bf16: a direct call,
              no model path reaches them, so their launches are the PGCN
              path's bf16 ones, 0), each held to its plain version (a bf16
              result to one bf16 ulp, a bf16 grad to 2**-6 relative plus
              2**-8 of its largest value), with
              `matmul_ms` of one bf16 torch.matmul and `bound_ms` at the
              dense bf16 rate (989 TFLOP/s), and `products`: each product
              pass's rows (all B*N, or the valid rows R of K4 and of the
              pooled forward's valid-rows form), TFLOP/s and one cuBLAS bf16
              matmul of its shape (the fused forward: pass A and the fused
              product); every GAT path, bf16 or float32, must launch the
              fused form for each per-slot forward, the valid-rows form for
              the pooled eval and train forms and the two-pass form for
              the pooled store form (`path_launches`, at N <= 64: every
              path's egonet); serving and training of
              PGAT-bf16 (config.mag.json with the key) and MTL-bf16
              (config.semeval_verb_mtl.json with the key, its switches) as
              above, launches read from the wrappers' `launches_bf16` (a
              float32 GAT launch on these paths fails the phase); the graph
              embeddings against the CPU plain path within 2**-7 of their
              largest value, the scores against the float32 model's from
              the same checkpoint within 0.05 of its mean |score|
              (tests/test_bf16.py's contract), `step_vs_cpu` (loss 1e-3,
              grads 2**-6 of each leaf's largest value), and a
              `bf16_steps` line: the median steps beside the float32 ones.
              PGAT-bf16's training runs the trainer's profiler window
              (`Trainer(profile_dir=)`, batches 1-4 of its 6-step epoch 1,
              epoch 1 with the sampled validation and its prefetch, epoch
              2 the full one) and a second window over one more epoch
              without the per-step sync; a `profile` line reads each trace
              back (wall ms, device-busy ms, the device's idle share, the
              top device operations), with the epochs' split and the
              checkpoint writer's and the prefetch's foreground seconds
              against the inline and foreground forms, and a train step's
              two host-to-device copies repaired (AMSGrad's bias
              corrections and the position embeddings' slot codes made on
              the card) against their form before the repair
              (`sync_repair`: the host syncs of one step under CUDA's sync
              debug mode, the median step, the window's idle share).
8. native_loader - the host data path (`phase_native_loader`): a dataset
              made by the port (`python -m
              taxoexpan_torch.tools.make_synthetic_dataset --v2`, 30000
              nodes, dim 250, max_children 40, seed 42, noise 1.0),
              `python -m taxoexpan_torch.train` on it at config.mag.json's
              full width (128 groups x 32 candidates a step), two epochs
              with sampled validation, once with loader backend "native"
              and once "python" in this process, same seed, the profiler
              window on: a finite loss that falls, K1t, K3t, K2, K4 and
              (validation) K1, K3 launched by both runs, the invariants of
              every native batch, the native batches equal to the Python
              ones where both are deterministic; per backend the epochs'
              wait_s, step_s, valid_s, egonets/s, epoch 2's median step
              and the window's device idle share; `tools.sampler_bench`'s
              batches/s on the same dataset; the simple_mlp baseline on
              the card against the CPU and trained one epoch there.
9. configurations - the repo's three other configuration files, each as
              published (paths WordNet and WordNet-bf16:
              config.wordnet.json, 300 + 50 -> 4 x 600, then 2400 + 50 ->
              1 x 300, BIM, N = 13 + 1 + 40 = 54; SemEval-Noun and
              SemEval-Noun-bf16: config.semeval_noun.json, 300 + 100 ->
              4 x 600, then 2400 + 100 -> 600, LBM, N = 64; Synthetic:
              config.synthetic.json, 64 + 32 -> 4 x 128, then 512 + 32 ->
              128, LBM, N = 30; every path's models built at its own
              expand_factor, `slot_args`): K1, K1t, K2 (need_dx off), K3,
              K3t and K4 at 4096 egonets of the path's widths and slots
              against their plain versions (entries "<wrapper>[wordnet]",
              "[wordnet, bf16]", "[semeval_noun]", "[semeval_noun,
              bf16]", "[synthetic]"), serving as in 5, one training epoch
              as in 6 at the configuration's own batch (64 groups: 2048 /
              1984 / 2048 egonets), and a `config_steps` line.
10. mag_full - MAG-Full scale (`phase_mag_full`): a 355,000-node
              `synthetic_taxonomy_v2` (dim 250, max_children 40, noise 1.0,
              seed 42: 319,446 candidates, 17,777 test queries, N = 52),
              config.mag.json as published (float32) with random weights,
              `test_fast -b 30000` over every test query against the whole
              catalog, then `infer -b 30000` on 8 novel terms; K1 and K3
              launched ceil(candidates / 30000) times by each CLI (11 by
              test_fast); a `mag_full` line with each stage's wall clock,
              each CLI's peak device memory and the host's max RSS; and
              K1 / K3 in eval form at one 30000-egonet chunk of these
              shapes against their plain versions (`[mag_full]` entries,
              each with its two-pass form's ms and passes beside it,
              the plain version run 4096 egonets a call).
11. a `phase_seconds` line (each phase's wall time) and a `{"kernels":
   [...]}` line (eval-form launches from the serving phase
   of the entry's path, the train-path kernels' from its training phase,
   K6's from the partitioned 2-rank run, over both ranks; the TP rows'
   from the PGAT-tp runs' counts at the shard's heads, `launches_by_heads`,
   over both runs and ranks; the `[native_loader]` rows, PGAT's K1-K4
   entries again, from the native_loader phase's native run; the
   `[mag_full]` rows from both MAG-Full CLIs' runs),
   then the card's nvidia-smi line, and last `{"ok": true, "device":
   {...}}`.

Imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import contextlib
import json
import os
import pickle
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent

# published peaks of one H100 SXM at its 700 W limit (NVIDIA data sheet):
# HBM bandwidth; the float32 forms compute at float32 accuracy with their
# products on the tensor cores in 3xTF32 (three TF32 products a float32
# one; plain TF32 would break parity with the plain versions), so they are
# bounded at a third of the dense TF32 rate; the float32 FMA rate outside
# the tensor cores is kept beside it as `bound_fma_ms`
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12
PEAK_3XTF32_FLOP_PER_S = 495e12 / 3
# the bf16 forms' products: bf16 operands on the tensor cores with float32
# accumulation, bounded at the data sheet's dense bf16 rate
PEAK_BF16_FLOP_PER_S = 989e12

# kernel vs plain version on the card: both float32, sums taken in another
# order (tiled K loop vs cuBLAS), so agreement is to rounding, not bits
RTOL, ATOL = 1e-4, 1e-4
# backward grads: dW and the slot sums reduce over all 262,144 rows of a
# batch in another order (split-K partial sums vs cuBLAS), with
# cancellation; held to 1e-3 relative plus 1e-3 of the grad's largest value
GRAD_RTOL, GRAD_ATOL_REL = 1e-3, 1e-3
# a bf16 result (a per-slot output, dx, dfc, dwa1, dwa2) against its plain
# version: kernel and plain version multiply the same bf16 operands exactly
# and sum in float32 in another order, so before its rounding a result
# agrees to the float32 forms' tolerance, and the rounding may then pick
# the neighbouring bf16 value: one ulp, 2**-7 relative, plus ATOL (float32
# sums over up to 3600 products, where the layer's output cancels to near
# 0); a bf16 grad is a sum over rows of D rounded to bf16 from float32
# values that differ by rounding, so an element of D may already sit one
# ulp apart: 2**-6 relative plus 2**-8 of the grad's largest value
BF16_RTOL, BF16_ATOL = 2 ** -7, ATOL
BF16_GRAD_RTOL, BF16_GRAD_ATOL_REL = 2 ** -6, 2 ** -8
# tests/test_bf16.py's contract: bf16 scores within 0.05 of the float32
# model's mean |score|
BF16_SCORE_REL = 0.05
# grandparent slots of every path's egonets (bench.py:237-238); the sibling
# slots are each configuration's expand_factor (`slot_args`): N = 13 + 1 +
# 50 = 64 for config.mag.json, MTL and SemEval-Noun, 54 for WordNet (40),
# 30 for Synthetic (16)
GP_SLOTS = 13
BATCH = 4096                   # egonets per kernel call: one encode_chunk
NODES, N_NOVEL, SEED = 4000, 8, 0
TRAIN_NODES = 800
REPLACES = {
    "gat_layer_fwd": "taxoexpan_tpu/ops/pallas_gat.py:838",
    "gat_layer_pooled_fwd": "taxoexpan_tpu/ops/pallas_gat.py:1105",
    "gat_layer_fwd_train": "taxoexpan_tpu/ops/pallas_gat.py:838",
    "gat_layer_pooled_fwd_train": "taxoexpan_tpu/ops/pallas_gat.py:1105",
    "gat_layer_bwd": "taxoexpan_tpu/ops/pallas_gat.py:991",
    "gat_layer_pooled_bwd": "taxoexpan_tpu/ops/pallas_gat.py:1188",
    "gcn_layer_fwd": "taxoexpan_tpu/ops/pallas_gcn.py:241",
    "gcn_layer_fwd_train": "taxoexpan_tpu/ops/pallas_gcn.py:241",
    "gcn_layer_bwd": "taxoexpan_tpu/ops/pallas_gcn.py:304",
    # K7a: the stored attention's write and read
    "gat_layer_fwd_train_store": "taxoexpan_tpu/ops/pallas_gat.py:231",
    "gat_layer_pooled_fwd_train_store": "taxoexpan_tpu/ops/pallas_gat.py:231",
    "gat_layer_bwd_stored": "taxoexpan_tpu/ops/pallas_gat.py:240",
    "gat_layer_pooled_bwd_stored": "taxoexpan_tpu/ops/pallas_gat.py:240",
    # K6: the ring halo exchange of the row-partitioned feature table
    "halo_gather": "taxoexpan_tpu/parallel/halo.py:195",
}
K7B = "taxoexpan_tpu/ops/pallas_gat.py:73"     # the 8-bit thresholds
STORED, BITS = "TAXOEXPAN_STORED_ATTN", "TAXOEXPAN_DROPOUT_BITS"
# the paths the smoke drives: configuration file, propagation, switches
PATHS = {
    "PGAT": ("config.mag.json", "PGAT", {}),
    "PGCN": ("config.mag.json", "PGCN", {}),
    "PGAT-stored": ("config.mag.json", "PGAT", {STORED: "1"}),
    "MTL": ("config.semeval_verb_mtl.json", "PGAT", {STORED: "1", BITS: "8"}),
    "PGAT-bf16": ("config.mag.json", "PGAT", {}),
    "MTL-bf16": ("config.semeval_verb_mtl.json", "PGAT",
                 {STORED: "1", BITS: "8"}),
    "PGAT-concat": ("config.mag.json", "PGAT", {}),
    "PGAT-concat-bf16": ("config.mag.json", "PGAT", {}),
    "PGCN-concat": ("config.mag.json", "PGCN", {}),
    "WordNet": ("config.wordnet.json", "PGAT", {}),
    "WordNet-bf16": ("config.wordnet.json", "PGAT", {}),
    "SemEval-Noun": ("config.semeval_noun.json", "PGAT", {}),
    "SemEval-Noun-bf16": ("config.semeval_noun.json", "PGAT", {}),
    "Synthetic": ("config.synthetic.json", "PGAT", {}),
}
# the paths whose configuration sets arch.args.compute_dtype "bfloat16"
# (as scripts/reference_scale_run.py:87 sets it): bf16 GAT layers
BF16_PATHS = ("PGAT-bf16", "MTL-bf16", "PGAT-concat-bf16", "WordNet-bf16",
              "SemEval-Noun-bf16")
# the paths of the repo's other three configuration files, each as
# published (bf16: with the key): WordNet (300 + 50 -> 4 x 600, then
# 2400 + 50 -> 1 x 300, BIM, N = 54), SemEval-Noun (300 + 100 -> 4 x 600,
# then 2400 + 100 -> 600, LBM, N = 64) and Synthetic (64 + 32 -> 4 x 128,
# then 512 + 32 -> 128, LBM, N = 30); the tag of their kernel entries
CONFIG_TAGS = {"config.wordnet.json": "wordnet",
               "config.semeval_noun.json": "semeval_noun",
               "config.synthetic.json": "synthetic"}
CONFIG_PATHS = tuple(path for path, spec in PATHS.items()
                     if spec[0] in CONFIG_TAGS)
# the paths whose configuration sets arch.args.pos_mode "concat": the pe
# rows appended to each layer's input (layer 0: 250 + 50 = 300 columns, the
# final layer 2000 + 50 = 2050 for PGAT, 500 + 50 for PGCN), layer 0 with
# its input grad
CONCAT_PATHS = ("PGAT-concat", "PGAT-concat-bf16", "PGCN-concat")
SERVING_PATHS = ("PGAT", "PGCN", "MTL", "PGAT-bf16", "MTL-bf16",
                 *CONCAT_PATHS, *CONFIG_PATHS)
TRAINING_PATHS = {"PGAT": 2, "PGCN": 2, "PGAT-stored": 1, "MTL": 2,
                  "PGAT-bf16": 2, "MTL-bf16": 1, "PGAT-concat": 1,
                  "PGAT-concat-bf16": 1, "PGCN-concat": 1,
                  **{path: 1 for path in CONFIG_PATHS}}
# the path whose training turns the trainer's profiler window on, and the
# window: batches 1-4 of epoch 1 (its 800-node epoch has 6 steps)
PROFILE_PATH, PROFILE_WINDOW = "PGAT-bf16", (1, 4)
# stored and recompute backwards on the card: the same expressions of
# gat_common.cuh in two translation units; equal bits expected
STORED_REL = 1e-6
# the data-parallel path: 2 rank processes sharing the card, config.mag.json
# at full width, its 128 groups a step split 64 a rank; the halo exchange
# of its partitioned run (ring: K6 through CUDA IPC)
DP_RANKS, DP_HALO, DP_TIMEOUT_S = 2, "ring", 600


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def time_ms(fn, iters: int) -> float:
    """Mean device time of one call, from CUDA events around `iters` calls
    after two warm-up calls."""
    import torch
    for _ in range(2):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def compare(name: str, got, want, rtol=None, atol=None) -> dict:
    """got against want within atol + rtol |want| elementwise; by default
    RTOL / ATOL, or BF16_RTOL / BF16_ATOL for a bf16 result."""
    import torch
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{name}: {got.dtype} {tuple(got.shape)} != "
                             f"{want.dtype} {tuple(want.shape)}")
    low = got.dtype == torch.bfloat16
    rtol = (BF16_RTOL if low else RTOL) if rtol is None else rtol
    atol = (BF16_ATOL if low else ATOL) if atol is None else atol
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite values")
    diff = (got - want).abs()
    bad = diff > atol + rtol * want.abs()
    rel = diff / want.abs().clamp(min=max(atol, 1e-30))
    res = {"max_abs_err": float(diff.max()), "max_rel_err": float(rel.max()),
           "rtol": rtol, "atol": atol}
    if bool(bad.any()):
        worst = int((diff - rtol * want.abs()).masked_fill(~bad, -1).argmax())
        res.update(failing=int(bad.sum()), worst_got=float(got.flatten()[
            worst]), worst_want=float(want.flatten()[worst]))
        raise AssertionError(f"{name} disagrees with its plain version: "
                             f"{res}")
    return res


# ----------------------------------------------------------------- phases

def phase_device() -> dict:
    import torch
    line = nvidia_smi_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    info = {"nvidia_smi": line, "name": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(), "torch": torch.__version__,
            "cuda": torch.version.cuda}
    emit("device", **info)
    return info


def phase_build() -> None:
    from taxoexpan_torch import native
    from taxoexpan_torch.ops import cuda_build
    t0 = time.time()
    logs = cuda_build.build_all()
    ptxas = {name: [ln.strip() for ln in text.splitlines()
                    if "registers" in ln or "spill" in ln]
             for name, text in logs.items()}
    t1 = time.time()
    # the native sampler (g++), which the loaders' "auto" backend then
    # takes in every phase; a failed build raises here
    library = native.build()
    emit("build", seconds=round(t1 - t0, 3),
         sources=[f"taxoexpan_torch/ops/csrc/{n}.cu" for n in logs],
         ptxas=ptxas, native_sampler=str(library.relative_to(REPO)),
         native_sampler_s=round(time.time() - t1, 3))


def load_config(name: str) -> dict:
    return json.loads((REPO / "configs" / name).read_text())


def path_model(path: str = "PGAT"):
    """The configuration of a path (configs/config.mag.json with
    `arch.args.propagation_method` set: PGAT as published, PGCN the
    paper's other propagation family at the same widths;
    configs/config.semeval_verb_mtl.json and the CONFIG_PATHS' files as
    published; the BF16_PATHS with `arch.args.compute_dtype` "bfloat16",
    the CONCAT_PATHS with `arch.args.pos_mode` "concat"), and the port's
    model of it at the configuration's egonet layout (`slot_args`)."""
    from taxoexpan_torch import builders
    name, propagation, _env = PATHS[path]
    cfg = load_config(name)
    cfg["arch"]["args"]["propagation_method"] = propagation
    if path in BF16_PATHS:
        cfg["arch"]["args"]["compute_dtype"] = "bfloat16"
    if path in CONCAT_PATHS:
        cfg["arch"]["args"]["pos_mode"] = "concat"
    model = builders.build_model(cfg["arch"], **slot_args(cfg))
    return cfg, model


def slot_args(cfg: dict) -> dict:
    """The egonet layout of a configuration's models and loaders: GP_SLOTS
    grandparent slots and the configuration's own expand_factor sibling
    slots."""
    return {"max_parents": GP_SLOTS,
            "expand_factor": cfg["train_data_loader"]["args"]
            ["expand_factor"]}


@contextlib.contextmanager
def switches(env: dict):
    """The path's environment switches, set for the block only."""
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _eval_wrappers(path: str) -> dict:
    """The eval-form kernel wrappers a serving run of `path` goes through
    (MTL's PATR readout takes the per-slot final layer)."""
    from taxoexpan_torch.ops import gat_kernels as gk
    from taxoexpan_torch.ops import gcn_kernels as ck
    if PATHS[path][1] in ("GCN", "PGCN"):
        return {"gcn_layer_fwd": ck.gcn_layer_fwd}
    if path.startswith("MTL"):
        return {"gat_layer_fwd": gk.gat_layer_fwd}
    return {"gat_layer_fwd": gk.gat_layer_fwd,
            "gat_layer_pooled_fwd": gk.gat_layer_pooled_fwd}


def path_launches(path: str, wrappers: dict, slots: int | None = None
                  ) -> dict:
    """The launch counts of `wrappers` in the path's compute dtype: their
    bf16 kernels' on a BF16_PATHS path (which then must have launched no
    float32 GAT kernel: raises), else their float32 kernels', and their
    bf16 kernels' under "<name>[bf16]" (K5's bf16 form has no path of its
    own: PGCN's count of it is its count on the main paths). Also the
    launches by form under "<name>[<form>]", each of which must be the form
    the path's shape takes (raises otherwise): on a GAT path, of either
    dtype, the forwards' (`gk.fwd_form` at N = `slots`, by default the
    path's egonet, GP_SLOTS + 1 + its expand_factor: every per-slot forward
    the fused form, the pooled eval and train forms the valid-rows form,
    the pooled store form the two-pass form); on a GCN path K5's
    (`ck.form`: at N <= 64 every K5 call the valid-rows form)."""
    import torch
    from taxoexpan_torch.ops import gat_kernels as gk
    bf16 = path in BF16_PATHS
    if bf16:
        f32 = {name: w.launches for name, w in gk.WRAPPERS.items()
               if w.launches}
        if f32:
            raise AssertionError(f"the bf16 path {path} launched float32 "
                                 f"kernels {f32}")
        res = {name: w.launches_bf16 for name, w in wrappers.items()}
    else:
        res = {name: w.launches for name, w in wrappers.items()} | {
            f"{name}[bf16]": w.launches_bf16
            for name, w in wrappers.items()}
    forms = {f"{name}[{form}]": count for name, w in wrappers.items()
             for form, count in getattr(w, "launches_by_form", {}).items()}
    if PATHS[path][1] in ("GCN", "PGCN"):
        expected = lambda name: "valid_rows"  # noqa: E731
    else:
        if slots is None:
            slots = GP_SLOTS + 1 + slot_args(load_config(PATHS[path][0]))[
                "expand_factor"]
        shape = torch.empty((1, slots, 1),
                            dtype=torch.bfloat16 if bf16 else torch.float32)
        expected = lambda name: gk.fwd_form(  # noqa: E731
            shape, "pooled" in name, name.endswith("_store"))
    other = {key: count for key, count in forms.items()
             if key.split("[")[1][:-1] != expected(key.split("[")[0])}
    if other:
        raise AssertionError(f"the path {path} launched forms {other}")
    return res | forms


def _train_wrappers(path: str) -> tuple[dict, tuple]:
    """Every wrapper of the path's kernel module, and the names a training
    run must launch."""
    from taxoexpan_torch.ops import gat_kernels as gk
    from taxoexpan_torch.ops import gcn_kernels as ck
    if PATHS[path][1] in ("GCN", "PGCN"):
        return ck.WRAPPERS, ("gcn_layer_fwd_train", "gcn_layer_bwd")
    if path == "PGAT-stored":
        return gk.WRAPPERS, ("gat_layer_fwd_train_store",
                             "gat_layer_pooled_fwd_train_store",
                             "gat_layer_bwd_stored",
                             "gat_layer_pooled_bwd_stored")
    if path.startswith("MTL"):
        return gk.WRAPPERS, ("gat_layer_fwd_train_store",
                             "gat_layer_bwd_stored")
    return gk.WRAPPERS, ("gat_layer_fwd_train", "gat_layer_pooled_fwd_train",
                         "gat_layer_bwd", "gat_layer_pooled_bwd")


def random_egonets(gen, b: int, din: int, device, sib: int,
                   gp: int = GP_SLOTS):
    """Unit-norm features [B, N, din], N = gp + 1 + sib, with random ngp in
    [0, gp] and nsib in [0, sib], invalid slots zeroed as gather_feats
    leaves them; the first rows are empty egonets (ngp = nsib = 0) and full
    ones."""
    import torch
    from taxoexpan_torch.ops import star
    n = gp + 1 + sib
    ngp = torch.randint(0, gp + 1, (b,), generator=gen, dtype=torch.int32)
    nsib = torch.randint(0, sib + 1, (b,), generator=gen, dtype=torch.int32)
    ngp[:4] = torch.tensor([0, 0, gp, gp], dtype=torch.int32)
    nsib[:4] = torch.tensor([0, sib, 0, sib], dtype=torch.int32)
    x = torch.randn((b, n, din), generator=gen)
    x = x / x.norm(dim=-1, keepdim=True)
    x = x * star.node_mask(ngp, nsib, gp, n)[..., None]
    return x.to(device), ngp.to(device), nsib.to(device)


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def fwd_work(pooled: bool, x, ops, pe_pack, ngp, nsib, heads: int, *outs,
             gp: int = GP_SLOTS):
    """(bytes, operations) a forward needs on these inputs: each input read
    once and each output (`outs`) written once, at their element sizes;
    the [x | pe] @ [fc | wa1 | wa2] products over the rows the output
    depends on, plus the aggregation (`gp` grandparent slots)."""
    b, n, din = x.shape
    hd = ops[0].shape[1]
    dh = hd // heads
    kx = din + (pe_pack[0].shape[1] if pe_pack else 0)
    nbytes = _nbytes(x, *ops, ngp, nsib, *(pe_pack or ()), *outs)
    ngp_sum = float(ngp.double().sum())
    if not pooled:
        rows = b * n                      # every slot is an output row
        agg = (heads * dh * (3 * b * (n - gp - 1) + 2 * (ngp_sum + b))
               + b * n * hd)
    else:
        # invalid slots contribute nothing to the pools
        rows = float((ngp + 1 + nsib).double().sum())
        nsib_sum = float(nsib.double().sum())
        agg = heads * dh * (3 * nsib_sum + 2 * (ngp_sum + b) + ngp_sum)
    flops = 2.0 * rows * kx * (hd + 2 * heads) + agg
    return nbytes, flops


def bwd_work(x, ops, pe_pack, g, grads: dict, ngp, nsib, heads: int,
             attn=None):
    """(bytes, operations) a backward needs on these inputs: inputs (x,
    weights, pe operands, the incoming grad, the stored softmax weights)
    read once, the grads written once; over the rows the grads depend on
    (the valid slots: the incoming grad is zero on the others), the
    recompute of [x | pe] @ W, the dW product, the dx / dpe product and
    about 8 operations a (row, column) for the aggregation's backward."""
    b, n, din = x.shape
    hd = ops[0].shape[1]
    pos = pe_pack[0].shape[1] if pe_pack else 0
    wd, kx = hd + 2 * heads, din + pos
    nbytes = _nbytes(x, *ops, ngp, nsib, *(pe_pack or ()), g, attn,
                     *grads.values())
    rows = float((ngp + 1 + nsib).double().sum())
    dx_cols = (din if grads.get("x") is not None else 0) + pos
    flops = 2.0 * rows * wd * (2 * kx + dx_cols) + 8.0 * rows * hd
    return nbytes, flops


def gcn_fwd_work(x, ops, pe_pack, ngp, nsib, out):
    """(bytes, operations) a K5 forward needs on these inputs: each input
    read once and the output `out` written once; the [x | pe] @ [W_h; W_p]
    product over the valid slots (an invalid slot's output is the bias
    alone) plus about 5 operations a (valid slot, column) for the norms,
    the star sum, the bias and the activation."""
    din, dout = x.shape[2], ops[0].shape[1]
    kx = din + (pe_pack[0].shape[1] if pe_pack else 0)
    nbytes = _nbytes(x, *ops, ngp, nsib, *(pe_pack or ()), out)
    rows = float((ngp + 1 + nsib).double().sum())
    return nbytes, 2.0 * rows * kx * dout + 5.0 * rows * dout


def gcn_bwd_work(x, ops, pe_pack, g, grads: dict, ngp, nsib, alpha):
    """(bytes, operations) a K5 backward needs on these inputs: inputs and
    the incoming grad read once, the grads written once; over the valid
    slots (dz is 0 on the others), the recompute of [x | pe] @ W where the
    layer has an activation, the dW product, the dx / dpe product and about
    8 operations a (slot, column) for the aggregation's backward."""
    din, dout = x.shape[2], ops[0].shape[1]
    pos = pe_pack[0].shape[1] if pe_pack else 0
    nbytes = _nbytes(x, *ops, ngp, nsib, *(pe_pack or ()), g,
                     *grads.values())
    rows = float((ngp + 1 + nsib).double().sum())
    dx_cols = (din if grads.get("x") is not None else 0) + pos
    products = (2 if alpha is not None else 1) * (din + pos) + dx_cols
    return nbytes, 2.0 * rows * dout * products + 8.0 * rows * dout


def _bound(nbytes: float, flops: float, tensor_cores: bool = False,
           bf16: bool = False) -> dict:
    """The least time for the work: its bytes at the HBM rate or its
    operations at the peak rate of the units that run them, whichever is
    longer (`bound_ms`). A bf16 form's operations run at the dense bf16
    tensor-core rate; a float32 form whose products run on the tensor cores
    in 3xTF32 (`tensor_cores`) at 3xTF32's, all its operations counted at
    that rate, with the float32 FMA rate's figure beside it as
    `bound_fma_ms`; any other form at the float32 FMA rate."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    res = {"bytes": nbytes, "operations": flops}
    if bf16:
        rate, res["bound_rate"] = PEAK_BF16_FLOP_PER_S, "bf16 989 TFLOP/s"
    elif tensor_cores:
        rate = PEAK_3XTF32_FLOP_PER_S
        res["bound_rate"] = "3xTF32 165 TFLOP/s"
        res["bound_fma_ms"] = max(
            t_bytes, flops / PEAK_F32_FLOP_PER_S * 1e3)
    else:
        rate, res["bound_rate"] = PEAK_F32_FLOP_PER_S, "float32 67 TFLOP/s"
    t_ops = flops / rate * 1e3
    res["bound_ms"] = max(t_bytes, t_ops)
    res["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    return res


def pass_split(kernel, which: str, calls: int = 3) -> dict:
    """Mean device ms of each pass of `kernel` (one wrapper call) over
    `calls` calls, from CUDA events the kernel library records between its
    launches: which = "gat_fwd:<form>" (K1 / K3 by their form,
    `gk.fwd_form`: "two_pass" stage and pack, projection, star or pooled
    star pass; "fused" stage and pack, pass A (a1 | a2), the star weights,
    the product with the star epilogue; "valid_rows" the valid rows
    counted, staged and W
    packed, the projection on them, the pooled star pass; `fwd_passes`),
    "gat_bwd" (K2 / K4: stage and pack, projection,
    head core, slot-bias sums, dW, dx), "gat_bwd_bf16" (their bf16 forms:
    stage and pack, with K4's valid rows counted and compacted; projection;
    the head core writing D in bf16; the reduction of its slot-bias
    partials; dW; dx), "gcn_fwd[:<form>]" (K5f by its form, `ck.form`, in
    either dtype: "two_pass", the default, stage and pack, projection, star
    pass; "valid_rows" the packed rows' offsets and tables, the rows staged
    and W packed, the product with the star epilogue) or
    "gcn_bwd[:<form>]" (K5b, either dtype: stage and pack, or the valid
    rows compacted and staged; projection; the dz pass; the db / d z_bias
    sums; dW; dx)."""
    from taxoexpan_torch.ops import gat_kernels as gk
    from taxoexpan_torch.ops import gcn_kernels as ck
    which, _, form = which.partition(":")
    fn = {"gat_fwd": lambda call: gk.fwd_pass_ms(call, form),
          "gat_bwd": gk.bwd_pass_ms,
          "gat_bwd_bf16": lambda call: gk.bwd_pass_ms(call, bf16=True),
          "gcn_fwd": lambda call: ck.fwd_pass_ms(call, form or "two_pass"),
          "gcn_bwd": lambda call: ck.bwd_pass_ms(call,
                                                 form or "two_pass")}[which]
    runs = [fn(kernel) for _ in range(calls)]
    return {k: sum(r[k] for r in runs) / calls for k in runs[0]}


def bwd_passes(x) -> str:
    """The pass split of a star-GAT backward on x (`pass_split`)."""
    import torch
    return "gat_bwd_bf16" if x.dtype == torch.bfloat16 else "gat_bwd"


def fwd_passes(x, pooled: bool, store: bool = False) -> str:
    """The pass split of a star-GAT forward on x (`pass_split`), by the
    form the wrapper launches (`gk.fwd_form`)."""
    from taxoexpan_torch.ops import gat_kernels as gk
    return f"gat_fwd:{gk.fwd_form(x, pooled, store)}"


def product_rates(x, ops, pe_pack, heads: int, ngp, nsib, passes: dict,
                  backward: bool, pooled: bool, need_dx: bool,
                  store: bool = False) -> dict:
    """The product passes of a star-GAT form (csrc/gemm_wgmma.cuh: bf16, or
    3xTF32 for float32): for the projection (the fused forward: pass A,
    a1 | a2, and the fused product, ft with the star pass in its epilogue)
    and, in a backward, dW (with its operand transposed into hi / lo
    planes in float32, and its split reduction) and dx (with the dpe
    sums), the rows it runs (all B*N, or the valid rows R of K4 and of the
    pooled forward's valid-rows form), its operations, its TFLOP/s
    (float32: float32-equivalent) from its pass ms, and one torch.matmul
    (cuBLAS) at the same shape on random operands of x's dtype (float32:
    full float32, TF32 off) as a yardstick, not used by the port."""
    from taxoexpan_torch.ops import gat_kernels as gk
    b, n, din = x.shape
    hd = ops[0].shape[1]
    pos = pe_pack[0].shape[1] if pe_pack else 0
    kx, wd = din + pos, hd + 2 * heads
    valid = int((ngp.long() + 1 + nsib.long()).sum())
    form = None if backward else gk.fwd_form(x, pooled, store)
    rows = valid if (backward and pooled) or form == "valid_rows" else b * n
    if form == "fused":
        shapes = {"pass_a": ((rows, kx), (kx, 2 * heads), False),
                  "fused_product": ((rows, kx), (kx, hd), False)}
    elif form == "valid_rows":
        shapes = {"projection_rows": ((rows, kx), (kx, wd), False)}
    else:
        shapes = {"projection": ((rows, kx), (kx, wd), False)}
    if backward:
        shapes["dw"] = ((rows, kx), (rows, wd), True)   # X^T @ D
        cols = (din if need_dx else 0) + pos
        if cols:
            shapes["dx"] = ((rows, wd), (wd, cols), False)
    out = {"rows": rows, "valid_rows": valid, **({"form": form} if form
                                                  else {})}
    return out | matmul_rates(x, shapes, passes)


def matmul_rates(x, shapes: dict, passes: dict) -> dict:
    """For each product pass `name` of `shapes` ({name: (A's shape, B's
    shape, A read transposed)}): its operations, its TFLOP/s from its pass
    ms in `passes`, and one torch.matmul at the same shape on random
    operands of x's dtype (float32: TF32 off) as a yardstick, not used by
    the port."""
    import torch
    out = {"matmul_dtype": str(x.dtype).replace("torch.", "")}
    gen = torch.Generator(device=x.device).manual_seed(SEED)
    for name, (sa, sb, trans) in shapes.items():
        a = torch.randn(sa, generator=gen, device=x.device, dtype=x.dtype)
        w = torch.randn(sb, generator=gen, device=x.device, dtype=x.dtype)
        mm, kk = (sa[1], sa[0]) if trans else sa
        flops = 2.0 * mm * kk * sb[1]
        lib_ms = time_ms((lambda: a.T @ w) if trans else (lambda: a @ w), 5)
        ms = passes[name]
        out[name] = {"m": mm, "k": kk, "n": sb[1], "gflop": flops / 1e9,
                     "ms": ms, "tflops": flops / ms / 1e9,
                     "cublas_ms": lib_ms,
                     "cublas_tflops": flops / lib_ms / 1e9}
        del a, w
    torch.cuda.empty_cache()
    return out


def compare_grads(name: str, got: dict, want: dict) -> dict:
    """Every grad the kernel returned against the plain version's (the bf16
    grads of a bf16 layer at BF16_GRAD_RTOL / _ATOL_REL)."""
    import torch
    worst = {"max_abs_err": 0.0, "max_rel_err": 0.0}
    for key, g in got.items():
        if g is None:
            continue
        scale = float(want[key].float().abs().max())
        low = g.dtype == torch.bfloat16
        res = compare(f"{name} d{key}", g, want[key],
                      rtol=BF16_GRAD_RTOL if low else GRAD_RTOL,
                      atol=(BF16_GRAD_ATOL_REL if low else GRAD_ATOL_REL)
                      * scale)
        for k in worst:
            worst[k] = max(worst[k], res[k])
    low = sorted(k for k, v in got.items()
                 if v is not None and v.dtype == torch.bfloat16)
    return {**worst, "rtol": GRAD_RTOL, "atol": f"{GRAD_ATOL_REL} x max|grad|",
            **({"bf16_grads": low, "bf16_rtol": BF16_GRAD_RTOL,
                "bf16_atol": f"{BF16_GRAD_ATOL_REL} x max|grad|"}
               if low else {}),
            "grads": sorted(k for k, v in got.items() if v is not None)}


def compare_outputs(name: str, got, want) -> dict:
    """A forward's output, or each of (output, stored softmax weights) of a
    store form, against the plain version's."""
    if not isinstance(got, tuple):
        return compare(name, got, want)
    res = [compare(f"{name} {part}", a, b)
           for part, a, b in zip(("out", "attn"), got, want)]
    return {**res[0], **{k: max(r[k] for r in res)
                         for k in ("max_abs_err", "max_rel_err")},
            "outputs": ["out", "attn"]}


def stored_vs_recompute(name: str, stored: dict, recompute: dict) -> float:
    """Largest difference between a stored backward's grads and the
    recompute backward's on the same inputs, relative to each grad's
    largest value; raises above STORED_REL."""
    worst = 0.0
    for key, g in stored.items():
        if g is None:
            continue
        g, ref = g.float(), recompute[key].float()
        scale = max(float(ref.abs().max()), 1e-30)
        worst = max(worst, float((g - ref).abs().max()) / scale)
    if worst > STORED_REL:
        raise AssertionError(f"{name}: stored and recompute grads differ by "
                             f"{worst} of the grad's largest value")
    return worst


def measure(name: str, kernel, plain, backward: bool, matmul,
            passes: str | None = None) -> tuple:
    """The kernel once against its plain version, then the device times of
    the kernel, the plain version and the torch.matmul yardstick, and with
    `passes` the split of the kernel's time by pass (`pass_split`).
    Returns (the kernel's result, the record's numbers)."""
    import torch
    with torch.no_grad():
        got = kernel()
        torch.cuda.synchronize()
        want = plain()
        err = (compare_grads(name, got, want) if backward
               else compare_outputs(name, got, want))
        del want
        times = {"ms": time_ms(kernel, 5 if backward else 10),
                 "plain_ms": time_ms(plain, 3),
                 "matmul_ms": time_ms(matmul, 5 if backward else 10)}
        if passes is not None:
            times["passes_ms"] = pass_split(kernel, passes)
    return got, {**err, **times}


def two_pass_form(name: str, kernel, got, plain=None,
                  iters: int = 10) -> dict:
    """The two-pass form of a star-GAT forward call (`gk.use_form`), the
    form its shape took before the fused and valid-rows forms: held to the
    plain version where `plain` is given, its largest difference from the
    shape's own form's result `got` (0: equal bits), its ms and passes."""
    import torch
    from taxoexpan_torch.ops import gat_kernels as gk
    with gk.use_form("two_pass"), torch.no_grad():
        two = kernel()
        torch.cuda.synchronize()
        res = {"form": "two_pass"}
        if plain is not None:
            want = plain()
            res.update(compare_outputs(f"{name} two-pass form", two, want))
            del want
        pairs = zip(two, got) if isinstance(got, tuple) else ((two, got),)
        res["max_diff_vs_form"] = max(float((a - b).abs().max())
                                      for a, b in pairs)
        del two
        res["ms"] = time_ms(kernel, iters)
        res["passes_ms"] = pass_split(kernel, "gat_fwd:two_pass")
    return res


def pooled_star_alone(name: str, x, ops, ngp, nsib, heads: int,
                      train_kw: dict, store: bool = False) -> dict:
    """K3's pooled star pass alone (`gat_pooled_star`) on the projection the
    card computes for these inputs (`gat_projection`), against its plain
    version on the same projection: the pools and, with `store`, the
    softmax weights. The launches of both are outside every path's count."""
    import torch
    from taxoexpan_torch.ops import gat_kernels as gk
    pkw = {k: train_kw[k] for k in ("pe_pack", "seed", "feat_drop",
                                    "dropout_bits") if k in train_kw}
    skw = {k: train_kw[k] for k in ("seed", "attn_drop", "dropout_bits")
           if k in train_kw}
    with torch.no_grad():
        proj = gk.gat_projection(x, *ops, **pkw)
        got = gk.gat_pooled_star(proj, ngp, nsib, GP_SLOTS, heads, store=store,
                                 **skw)
        torch.cuda.synchronize()
        want = gk.gat_pooled_star_plain(proj, ngp, nsib, GP_SLOTS, heads,
                                        store_attn=store, **skw)
        res = compare_outputs(f"{name} pooled star pass", got, want)
    del proj, got, want
    return res


def packed_rows(ngp, nsib, p: int, n: int, tile: int = 64) -> int:
    """The rows K5 bf16's forward packs the valid rows of whole egonets
    into: next fit into `tile`-row tiles, in egonet order
    (csrc/gcn.cu:packed_row_offsets_kernel)."""
    pos = tiles = 0
    for c in (ngp.clamp(0, p) + 1 + nsib.clamp(0, n - p - 1)).tolist():
        if pos + c > tile:
            tiles, pos = tiles + 1, 0
        pos += c
    return tiles * tile + pos


def gcn_product_rates(x, dout: int, pos: int, rows: int, passes: dict,
                      backward: bool, need_dx: bool, form: str,
                      alpha) -> dict:
    """The product passes of a K5 form (csrc/gemm_wgmma.cuh: 3xTF32 for
    float32, bf16 for bf16) beside one torch.matmul of each shape
    (`matmul_rates`): the forward's product over the rows it runs (the
    valid-rows form: the packed rows, with the star pass in its epilogue;
    the two-pass form: all B*N rows, the projection into z); in a
    backward, over `rows` rows (the valid rows R, or all B*N rows), the
    recompute of z where the layer has an activation, dW (with its operand
    transposed into hi / lo planes in float32, and its split reduction)
    and dx (with the dpe sums)."""
    kx = x.shape[2] + pos
    if not backward:
        name = "product_star" if form == "valid_rows" else "projection"
        shapes = {name: ((rows, kx), (kx, dout), False)}
    else:
        shapes = {"projection": ((rows, kx), (kx, dout), False)} \
            if alpha is not None else {}
        shapes["dw"] = ((rows, kx), (rows, dout), True)   # X^T @ dz
        cols = (x.shape[2] if need_dx else 0) + pos
        if cols:
            shapes["dx"] = ((rows, dout), (dout, cols), False)
    return {"rows": rows, "form": form} | matmul_rates(x, shapes, passes)


def gcn_star_alone(name: str, x, ops, ngp, nsib, alpha,
                   train_kw: dict) -> dict:
    """K5f's star pass alone (`gcn_star`) on the projection the card
    computes for these inputs (`gcn_projection`, the train form's where
    `train_kw` has a pe path), against its plain version on the same z. The
    launches of both are outside every path's count."""
    import torch
    from taxoexpan_torch.ops import gcn_kernels as ck
    pkw = {k: train_kw[k] for k in ("pe_pack", "seed", "drop")
           if k in train_kw}
    with torch.no_grad():
        z = ck.gcn_projection(x, ops[0], ops[2], **pkw)
        got = ck.gcn_star(z, ops[1], ngp, nsib, GP_SLOTS, alpha)
        torch.cuda.synchronize()
        res = compare(f"{name} star pass", got,
                      ck.gcn_star_plain(z, ops[1], ngp, nsib, GP_SLOTS, alpha))
    del z, got
    return res


def phase_masks(device) -> dict:
    """The dropout generator of the kernels against the plain version."""
    import torch
    from taxoexpan_torch.ops import dropout
    for (seed, stream, row, col), want in dropout.GOLDEN_BITS:
        got = dropout.bits(seed, stream, torch.tensor([row], device=device),
                           torch.tensor([col], device=device))
        if int(got[0]) != want:
            raise AssertionError(f"golden bits of {(seed, stream, row, col)}"
                                 f": card {int(got[0])}, pinned {want}")
    gen = torch.Generator().manual_seed(SEED)
    rows = torch.randint(0, 2 ** 32, (1 << 20,), generator=gen,
                         dtype=torch.int64)
    cols = torch.randint(0, 2 ** 32, (1 << 20,), generator=gen,
                         dtype=torch.int64)
    got = dropout.bits(7, 3, rows.to(device), cols.to(device)).cpu()
    mismatched = int((got != dropout.bits_plain(7, 3, rows, cols)).sum())
    if mismatched:
        raise AssertionError(f"{mismatched} of 2**20 bits differ between "
                             "the card and the plain generator")
    for (seed, stream, row, col), want in dropout.GOLDEN_BYTES8:
        got = dropout.bits(seed, stream, torch.tensor([row], device=device),
                           torch.tensor([col], device=device), width=8)
        if int(got[0]) != want:
            key = (seed, stream, row, col)
            raise AssertionError(f"golden 8-bit byte of {key}: card "
                                 f"{int(got[0])}, pinned {want}")
    got = dropout.bits(7, 3, rows.to(device), cols.to(device), width=8).cpu()
    mismatched8 = int((got != dropout.bytes8_plain(7, 3, rows, cols)).sum())
    if mismatched8:
        raise AssertionError(f"{mismatched8} of 2**20 8-bit bytes differ "
                             "between the card and the plain generator")
    res = {"golden": len(dropout.GOLDEN_BITS), "random_pairs": 1 << 20,
           "mismatched": mismatched,
           "golden_bytes8": len(dropout.GOLDEN_BYTES8),
           "random_pairs_bytes8": 1 << 20, "mismatched_bytes8": mismatched8}
    emit("masks", **res)
    return res


def phase_kernels(batch: int, device, drop: float,
                  path: str = "PGAT") -> list[dict]:
    """PGAT's K1-K4 (and K7a) at config.mag.json's shapes against their
    plain versions; with path "PGAT-bf16" their bf16 forms (x, fc, wa1, wa2
    in bf16; entries named "<wrapper>[bf16]"), without the store forms;
    with a CONCAT_PATHS path the forms pos_mode "concat" gives them (the pe
    columns in x: layer 0 at 250 + 50 = 300 input columns with its dx on,
    the pooled final layer at 2000 + 50 = 2050; no slot biases and no pe
    path, the feature dropout over all columns; entries
    "<wrapper>[concat]" and "<wrapper>[concat, bf16]"), without the store
    forms; with a CONFIG_PATHS path the same six forms at that
    configuration's widths and egonet layout (entries "<wrapper>[wordnet]",
    "[wordnet, bf16]", "[semeval_noun]", "[semeval_noun, bf16]",
    "[synthetic]")."""
    import torch
    from taxoexpan_torch.ops import gat_kernels as gk
    from taxoexpan_torch.ops import star
    from taxoexpan_torch.weights import params_to
    _cfg, model = path_model(path)
    bf16 = path in BF16_PATHS
    concat = path in CONCAT_PATHS
    tags = [t for t, on in ((CONFIG_TAGS.get(PATHS[path][0]), True),
                            ("concat", concat), ("bf16", bf16)) if t and on]
    tag = f"[{', '.join(tags)}]" if tags else ""
    gen = torch.Generator().manual_seed(SEED)
    prop = model.propagate
    params = params_to(model.init(gen), device)["propagate"]
    feats, ngp, nsib = random_egonets(gen, batch, prop.layer_specs[0][0]
                                      - prop.pos_dim, device,
                                      model.expand_factor)
    # the layer's input as the model makes it: pe columns appended under
    # concat, cast to the compute dtype
    x0 = prop.layer_input(params, feats, 0, GP_SLOTS)
    del feats
    n = x0.shape[1]
    # layer 0's dx: on where its input carries the trainable pe columns
    dx0 = prop.concat
    ops0, _ = prop.operands(params, 0, n, GP_SLOTS)
    ops1, _ = prop.operands(params, 1, n, GP_SLOTS)
    # train form: the pe rows and W_p tail rows as pe_pack, zero biases
    tops0, pe0 = prop.operands(params, 0, n, GP_SLOTS, pe_dropout=True)
    tops1, pe1 = prop.operands(params, 1, n, GP_SLOTS, pe_dropout=True)
    h0, h1 = prop.layer_specs[0][2], prop.layer_specs[1][2]
    tkw0 = dict(pe_pack=pe0, seed=11, feat_drop=drop, attn_drop=drop)
    tkw1 = dict(pe_pack=pe1, seed=12, feat_drop=drop, attn_drop=drop)
    with torch.no_grad():
        x1 = prop.layer_input(params, gk.gat_layer_fwd_plain(
            x0, *ops0, ngp, nsib, GP_SLOTS, h0, out_alpha=0.01), 1, GP_SLOTS)
        y0t = gk.gat_layer_train_plain(x0, *tops0, ngp, nsib, GP_SLOTS, h0,
                                       out_alpha=0.01, **tkw0)
        x1t = prop.layer_input(params, y0t, 1, GP_SLOTS)
    valid = star.node_mask(ngp, nsib, GP_SLOTS, n)[..., None]
    # incoming grads as the train step gives them: layer 1's dx is zero on
    # invalid slots; the pool grads are dense. Layer 0 fuses leaky_relu
    # (0.01), whose derivative jumps 100x at 0: where the recomputed
    # pre-activation lies within 1e-5 of 0, float32 rounding may put the
    # kernel and the plain version on different sides, so g0 is 0 there
    # and the comparison stays well-posed
    with torch.no_grad():
        pre = gk.gat_layer_train_plain(x0, *tops0, ngp, nsib, GP_SLOTS, h0,
                                       **tkw0)
        away = pre.float().abs() > 1e-5
        near_kink_share = 1.0 - float(away.double().mean())
        del pre
    # drawn on the card: a host draw of g0's 524 M elements takes seconds
    dgen = torch.Generator(device=device).manual_seed(SEED)
    g0 = ((torch.randn(y0t.shape, generator=dgen, device=device) * 1e-3)
          * valid * away).to(y0t.dtype)
    del away, y0t
    g1 = torch.randn((batch, 3, prop.out_dim), generator=dgen,
                     device=device) * 1e-2
    fwd, bwd = "taxoexpan_torch/ops/csrc/gat_fwd.cu", \
        "taxoexpan_torch/ops/csrc/gat_bwd.cu"
    cases = [
        ("gat_layer_fwd", fwd, False, x0, ops0, None, h0, None,
         lambda: gk.gat_layer_fwd(x0, *ops0, ngp, nsib, GP_SLOTS, h0,
                                  out_alpha=0.01),
         lambda: gk.gat_layer_fwd_plain(x0, *ops0, ngp, nsib, GP_SLOTS, h0,
                                        out_alpha=0.01)),
        ("gat_layer_pooled_fwd", fwd, True, x1, ops1, None, h1, None,
         lambda: gk.gat_layer_pooled_fwd(x1, *ops1, ngp, nsib, GP_SLOTS, h1),
         lambda: gk.gat_layer_pooled_fwd_plain(x1, *ops1, ngp, nsib, GP_SLOTS,
                                               h1)),
        ("gat_layer_fwd_train", fwd, False, x0, tops0, pe0, h0, None,
         lambda: gk.gat_layer_fwd_train(x0, *tops0, ngp, nsib, GP_SLOTS, h0,
                                        out_alpha=0.01, **tkw0),
         lambda: gk.gat_layer_train_plain(x0, *tops0, ngp, nsib, GP_SLOTS, h0,
                                          out_alpha=0.01, **tkw0)),
        ("gat_layer_pooled_fwd_train", fwd, True, x1t, tops1, pe1, h1, None,
         lambda: gk.gat_layer_pooled_fwd_train(x1t, *tops1, ngp, nsib,
                                               GP_SLOTS, h1, **tkw1),
         lambda: gk.gat_layer_train_plain(x1t, *tops1, ngp, nsib, GP_SLOTS, h1,
                                          pooled=True, **tkw1)),
        # layer 0's backward in the train step: need_dx off for fixed input
        # features, on under concat; slot-bias grads off (zero biases on
        # the pe path and under concat)
        ("gat_layer_bwd", bwd, False, x0, tops0, pe0, h0, dx0,
         lambda: gk.gat_layer_bwd(g0, x0, *tops0, ngp, nsib, GP_SLOTS, h0,
                                  out_alpha=0.01, need_dx=dx0,
                                  need_dbias=False, **tkw0),
         lambda: gk.gat_layer_bwd_plain(g0, x0, *tops0, ngp, nsib, GP_SLOTS,
                                        h0, out_alpha=0.01, need_dx=dx0,
                                        **tkw0)),
        ("gat_layer_pooled_bwd", bwd, True, x1t, tops1, pe1, h1, True,
         lambda: gk.gat_layer_pooled_bwd(g1, x1t, *tops1, ngp, nsib, GP_SLOTS,
                                         h1, need_dx=True, need_dbias=False,
                                         **tkw1),
         lambda: gk.gat_layer_bwd_plain(g1, x1t, *tops1, ngp, nsib, GP_SLOTS,
                                        h1, pooled=True, need_dx=True,
                                        **tkw1)),
    ]
    records = []
    for (wrapper, source, pooled, x, ops, pe_pack, heads, need_dx, kernel,
         plain) in cases:
        name = wrapper + tag
        backward = wrapper.endswith("_bwd")
        x2 = x.reshape(-1, x.shape[-1])
        fc = ops[0]
        if backward:
            d = torch.randn((x2.shape[0], fc.shape[1] + 2 * heads),
                            device=device).to(x.dtype)
            matmul = lambda: x2.T @ d  # noqa: E731
            call = "torch.matmul(x.reshape(-1, Din).T, D [B*N, H*Dh+2H])"
        else:
            matmul = lambda: x2 @ fc  # noqa: E731
            call = "torch.matmul(x.reshape(-1, Din), fc)"
        if bf16:
            call += " in bf16"
        # every GAT form runs its products on the tensor cores
        got, nums = measure(name, kernel, plain, backward, matmul,
                            bwd_passes(x) if backward
                            else fwd_passes(x, pooled))
        nums["products"] = product_rates(
            x, ops, pe_pack, heads, ngp, nsib, nums["passes_ms"], backward,
            pooled, bool(need_dx))
        if not backward:
            nums["form"] = gk.fwd_form(x, pooled)
            if path == "PGAT":  # the float32 two-pass form, held here
                nums["parent_form"] = two_pass_form(name, kernel, got, plain)
        if pooled and not backward:
            nums["star_alone"] = pooled_star_alone(
                name, x, ops, ngp, nsib, heads,
                tkw1 if "_train" in wrapper else {})
        if backward:
            del d
            nbytes, flops = bwd_work(x, ops, pe_pack, g1 if pooled else g0,
                                     got, ngp, nsib, heads)
        else:
            nbytes, flops = fwd_work(pooled, x, ops, pe_pack, ngp, nsib,
                                     heads, got)
        rec = {"name": name, "wrapper": wrapper, "path": path,
               "route": "cuda", "source": source,
               "replaces": REPLACES[wrapper], "batch": batch,
               "x_shape": list(x.shape), "fc_shape": list(fc.shape),
               "dtype": str(x.dtype).replace("torch.", ""),
               "pe": pe_pack is not None, "pos_mode": prop.pos_mode,
               **({"near_kink_share": near_kink_share}
                  if wrapper == "gat_layer_bwd" else {}),
               **({"need_dx": need_dx} if backward else {}),
               "dropout": drop if "_train" in wrapper or backward else 0.0,
               **nums,
               # no single PyTorch call computes the star-GAT layer or its
               # backward; one product alone is timed as a yardstick
               "library_ms": None, "matmul_call": call,
               **_bound(nbytes, flops, True, bf16)}
        emit("kernel", **rec)
        records.append(rec)
        del got
        torch.cuda.empty_cache()
    # K7a: the store forms of both train forwards, same seeds, and the
    # stored backwards fed their weights (in bf16 at MTL's shapes only,
    # phase_mtl_kernels: MTL-bf16 is the bf16 path that stores attention;
    # no concat path and no CONFIG_PATHS path stores attention)
    if bf16 or concat or path in CONFIG_PATHS:
        return records
    args = (ngp, nsib, GP_SLOTS)
    records += store_entries("", "PGAT-stored", False, x0, tops0, pe0, h0,
                             g0, tkw0, 0.01, False, args)
    records += store_entries("", "PGAT-stored", True, x1t, tops1, pe1, h1,
                             g1, tkw1, None, True, args)
    return records


def gat_record(name: str, wrapper: str, path: str, backward: bool, x, fc,
               pe_pack, nums: dict, work: tuple, replaces: str,
               **extra) -> dict:
    """Emit and return the record of one star-GAT kernel entry."""
    import torch
    bf16 = x.dtype == torch.bfloat16
    rec = {"name": name, "wrapper": wrapper, "path": path, "route": "cuda",
           "source": "taxoexpan_torch/ops/csrc/"
           + ("gat_bwd.cu" if backward else "gat_fwd.cu"),
           "replaces": replaces, "batch": x.shape[0],
           "x_shape": list(x.shape), "fc_shape": list(fc.shape),
           "dtype": str(x.dtype).replace("torch.", ""),
           "pe": pe_pack is not None, **extra,
           # a forward's form (`gk.fwd_form`)
           **({"form": nums["products"]["form"]}
              if "form" in nums.get("products", {}) else {}), **nums,
           # no single PyTorch call computes the star-GAT layer or its
           # backward; one product alone is timed as a yardstick
           "library_ms": None,
           "matmul_call": ("torch.matmul(x.reshape(-1, Din).T, "
                           "D [B*N, H*Dh+2H])" if backward else
                           "torch.matmul(x.reshape(-1, Din), fc)")
           + (" in bf16" if bf16 else ""),
           **_bound(*work, True, bf16)}
    emit("kernel", **rec)
    return rec


def store_entries(tag: str, path: str, pooled: bool, x, ops, pe_pack,
                  heads: int, g, train_kw: dict, out_alpha, need_dx: bool,
                  args, replaces: str | None = None) -> list[dict]:
    """The store form of a train forward (output and softmax weights
    against the plain version) and the stored backward fed its weights
    (grads against the plain version given the same weights, and against
    the recompute backward on the card: `stored_vs_recompute_rel`)."""
    import torch
    from taxoexpan_torch.ops import gat_kernels as gk
    ngp, nsib, _p = args
    fwd_w = (gk.gat_layer_pooled_fwd_train_store if pooled
             else gk.gat_layer_fwd_train_store)
    bwd_w = gk.gat_layer_pooled_bwd_stored if pooled \
        else gk.gat_layer_bwd_stored
    recompute_w = gk.gat_layer_pooled_bwd if pooled else gk.gat_layer_bwd
    akw = {} if pooled else {"out_alpha": out_alpha}
    ops_all = (x, *ops, *args, heads)
    bkw = dict(train_kw, need_dx=need_dx, **akw)
    x2 = x.reshape(-1, x.shape[-1])
    fc = ops[0]
    common = {"dropout": train_kw["feat_drop"],
              "dropout_bits": train_kw.get("dropout_bits", 32)}

    name = fwd_w.__name__
    (out, attn), nums = measure(
        name + tag, lambda: fwd_w(*ops_all, **train_kw, **akw),
        lambda: gk.gat_layer_train_plain(*ops_all, pooled=pooled,
                                         store_attn=True, **train_kw, **akw),
        False, lambda: x2 @ fc, fwd_passes(x, pooled, True))
    if pooled:
        nums["star_alone"] = pooled_star_alone(name + tag, x, ops, ngp, nsib,
                                               heads, train_kw, store=True)
    nums["products"] = product_rates(x, ops, pe_pack, heads, ngp, nsib,
                                     nums["passes_ms"], False, pooled,
                                     False, store=True)
    records = [gat_record(
        name + tag, name, path, False, x, fc, pe_pack, nums,
        fwd_work(pooled, x, ops, pe_pack, ngp, nsib, heads, out, attn),
        replaces or REPLACES[name], **common)]
    del out

    name = bwd_w.__name__
    d = torch.randn((x2.shape[0], fc.shape[1] + 2 * heads),
                    device=x.device).to(x.dtype)
    grads, nums = measure(
        name + tag, lambda: bwd_w(g, *ops_all, attn, need_dbias=False, **bkw),
        lambda: gk.gat_layer_bwd_plain(g, *ops_all, pooled=pooled,
                                       stored_attn=attn, **bkw),
        True, lambda: x2.T @ d, bwd_passes(x))
    del d
    nums["products"] = product_rates(x, ops, pe_pack, heads, ngp, nsib,
                                     nums["passes_ms"], True, pooled,
                                     need_dx)
    rel = stored_vs_recompute(name + tag, grads, recompute_w(
        g, *ops_all, need_dbias=False, **bkw))
    records.append(gat_record(
        name + tag, name, path, True, x, fc, pe_pack, nums,
        bwd_work(x, ops, pe_pack, g, grads, ngp, nsib, heads, attn),
        replaces or REPLACES[name], need_dx=need_dx,
        stored_vs_recompute_rel=rel, **common))
    del grads, attn
    torch.cuda.empty_cache()
    return records


def phase_mtl_kernels(batch: int, device, drop: float) -> list[dict]:
    """Both GAT layers of the SemEval-Verb MTL configuration at B egonets,
    with the config's dropout and 8-bit thresholds in the train forms, in
    float32 (path MTL) and in bf16 (path MTL-bf16: the same params and
    inputs, x, fc, wa1, wa2 in bf16). Layer 0 (300 + pe 100 -> 4 x 900,
    leaky_relu 0.01): K1 eval, the K1 train store form and the stored K2
    (need_dx off). The per-slot final layer (3600 + pe 100 -> 1 x 600, no
    activation), fed layer 0's eval output in the same dtype: K1 eval, the
    K1 train store form and the stored K2 (need_dx on)."""
    import torch
    from taxoexpan_torch.ops import gat_kernels as gk
    from taxoexpan_torch.ops import star
    from taxoexpan_torch.weights import params_to
    _cfg, model = path_model("MTL")
    gen = torch.Generator().manual_seed(SEED + 1)
    params = params_to(model.init(gen), device)["propagate"]
    prop = model.propagate
    x0, ngp, nsib = random_egonets(gen, batch, prop.layer_specs[0][0]
                                   - prop.pos_dim, device,
                                   model.expand_factor)
    n = x0.shape[1]
    args = (ngp, nsib, GP_SLOTS)
    h0, h1 = prop.layer_specs[0][2], prop.layer_specs[1][2]
    tkw0 = dict(seed=30, feat_drop=drop, attn_drop=drop, dropout_bits=8)
    tkw1 = dict(seed=31, feat_drop=drop, attn_drop=drop, dropout_bits=8)
    valid = star.node_mask(ngp, nsib, GP_SLOTS, n)[..., None]
    # the incoming grads, drawn once for both dtypes: layer 0's is zero on
    # invalid slots and where the pre-activation lies within 1e-5 of
    # leaky_relu's kink (as in phase_kernels); the readouts' grad reaches
    # the valid slots of the per-slot final layer
    dgen = torch.Generator(device=device).manual_seed(SEED + 1)
    noise0 = torch.randn((batch, n, prop.layer_specs[1][0] - prop.pos_dim),
                         generator=dgen, device=device) * 1e-3 * valid
    noise1 = torch.randn((batch, n, prop.out_dim), generator=dgen,
                         device=device) * 1e-2 * valid

    def eval_entry(tag, path, x, ops, heads, out_alpha):
        name = "gat_layer_fwd"
        x2 = x.reshape(-1, x.shape[-1])
        got, nums = measure(
            f"{name}{tag}",
            lambda: gk.gat_layer_fwd(x, *ops, *args, heads,
                                     out_alpha=out_alpha),
            lambda: gk.gat_layer_fwd_plain(x, *ops, *args, heads, out_alpha),
            False, lambda: x2 @ ops[0], fwd_passes(x, False))
        nums["products"] = product_rates(x, ops, None, heads, ngp, nsib,
                                         nums["passes_ms"], False, False,
                                         False)
        return got, gat_record(
            f"{name}{tag}", name, path, False, x, ops[0], None, nums,
            fwd_work(False, x, ops, None, ngp, nsib, heads, got),
            REPLACES[name], dropout=0.0)

    records = []
    for path in ("MTL", "MTL-bf16"):
        p = prop if path == "MTL" else path_model(path)[1].propagate
        bf = ", bf16" if path in BF16_PATHS else ""
        xin = x0.to(p.dtype)
        ops0, _ = p.operands(params, 0, n, GP_SLOTS)
        tops0, pe0 = p.operands(params, 0, n, GP_SLOTS, pe_dropout=True)
        # layer 0; its eval output is the final layer's input
        x1, rec = eval_entry(f"[mtl layer 0{bf}]", path, xin, ops0, h0, 0.01)
        records.append(rec)
        with torch.no_grad():
            pre = gk.gat_layer_train_plain(xin, *tops0, *args, h0,
                                           pe_pack=pe0, **tkw0)
            g0 = (noise0 * (pre.float().abs() > 1e-5)).to(p.dtype)
            del pre
        records += store_entries(f"[mtl layer 0, 8-bit{bf}]", path, False,
                                 xin, tops0, pe0, h0, g0,
                                 dict(tkw0, pe_pack=pe0), 0.01, False, args,
                                 replaces=K7B)
        del xin, g0
        torch.cuda.empty_cache()

        # the per-slot final layer
        ops1, _ = p.operands(params, 1, n, GP_SLOTS)
        tops1, pe1 = p.operands(params, 1, n, GP_SLOTS, pe_dropout=True)
        got, rec = eval_entry(f"[mtl final{bf}]", path, x1, ops1, h1, None)
        records.append(rec)
        del got
        records += store_entries(f"[mtl final, 8-bit{bf}]", path, False, x1,
                                 tops1, pe1, h1, noise1.to(p.dtype),
                                 dict(tkw1, pe_pack=pe1), None, True, args,
                                 replaces=K7B)
        del x1
        torch.cuda.empty_cache()
    return records


def phase_tp_kernels(batch: int, device, drop: float) -> list[dict]:
    """The star-GAT kernels at the shapes head tensor parallelism over
    mp = 2 gives them, mp index 0's shard, in float32 (paths PGAT-tp,
    PGAT-tp-pooled) and in bf16 (PGAT-tp-bf16, PGAT-tp-pooled-bf16): the
    layer-0 shard of config.mag.json (250 + pe 50 -> 2 x 500 of its 4
    heads, leaky_relu 0.01) as K1 eval, the K1 train form, its store form
    (K7a) with the stored K2, and K2 (need_dx off), the PGAT-tp path's
    layer 0; and the pooled layer's TP form, heads_local = 2 of a 4-head
    final layer (2000 + pe 50 -> 2 x 500, pools), which no configuration of
    the repo reaches (config.mag.json's final layer has 1 head and runs
    whole on both mp ranks): K3 eval, K3t and K4 (need_dx on). The same
    params and inputs in both dtypes; the pooled layer fed layer 0's whole
    eval output (what the mp gather gives it)."""
    import torch
    from taxoexpan_torch import builders
    from taxoexpan_torch.models.propagation import head_shard
    from taxoexpan_torch.ops import gat_kernels as gk
    from taxoexpan_torch.ops import star
    from taxoexpan_torch.weights import params_to
    cfg, _ = path_model("PGAT")
    heads, mp = 4, 2
    local = heads // mp
    gen = torch.Generator().manual_seed(SEED + 2)
    sib = slot_args(cfg)["expand_factor"]
    n = GP_SLOTS + 1 + sib
    x0, ngp, nsib = random_egonets(gen, batch, cfg["arch"]["args"]["in_dim"],
                                   device, sib)
    args = (ngp, nsib, GP_SLOTS)
    valid = star.node_mask(ngp, nsib, GP_SLOTS, n)[..., None]
    tkw0 = dict(seed=40, feat_drop=drop, attn_drop=drop)
    tkw1 = dict(seed=41, feat_drop=drop, attn_drop=drop)
    dgen = torch.Generator(device=device).manual_seed(SEED + 2)
    noise0 = torch.randn((batch, n, local * cfg["arch"]["args"]
                          ["hidden_dim"]), generator=dgen,
                         device=device) * 1e-3 * valid
    g1 = torch.randn((batch, 3, cfg["arch"]["args"]["out_dim"]),
                     generator=dgen, device=device) * 1e-2
    records = []
    params = None
    for path in ("PGAT-tp", "PGAT-tp-bf16"):
        bf16 = path.endswith("bf16")
        arch = dict(cfg["arch"], args=dict(
            cfg["arch"]["args"], heads=[heads, heads],
            compute_dtype="bfloat16" if bf16 else "float32"))
        prop = builders.build_model(arch, **slot_args(cfg)).propagate
        if params is None:
            params = params_to(prop.init(gen), device)
        bf = ", bf16" if bf16 else ""
        xin = x0.to(prop.dtype)

        def shard(l, pe_dropout=False):
            return head_shard(*prop.operands(params, l, n, GP_SLOTS,
                                             pe_dropout=pe_dropout),
                              heads, 0, mp)
        (ops0, _), (tops0, pe0) = shard(0), shard(0, True)
        kw0 = dict(tkw0, pe_pack=pe0)
        with torch.no_grad():
            pre = gk.gat_layer_train_plain(xin, *tops0, *args, local, **kw0)
            g0 = (noise0 * (pre.float().abs() > 1e-5)).to(prop.dtype)
            del pre
        tag = f"[tp shard{bf}]"
        cases = [
            ("gat_layer_fwd", False, xin, ops0, None,
             lambda: gk.gat_layer_fwd(xin, *ops0, *args, local,
                                      out_alpha=0.01),
             lambda: gk.gat_layer_fwd_plain(xin, *ops0, *args, local,
                                            out_alpha=0.01)),
            ("gat_layer_fwd_train", False, xin, tops0, pe0,
             lambda: gk.gat_layer_fwd_train(xin, *tops0, *args, local,
                                            out_alpha=0.01, **kw0),
             lambda: gk.gat_layer_train_plain(xin, *tops0, *args, local,
                                              out_alpha=0.01, **kw0)),
            ("gat_layer_bwd", False, xin, tops0, pe0,
             lambda: gk.gat_layer_bwd(g0, xin, *tops0, *args, local,
                                      out_alpha=0.01, need_dx=False,
                                      need_dbias=False, **kw0),
             lambda: gk.gat_layer_bwd_plain(g0, xin, *tops0, *args, local,
                                            out_alpha=0.01, need_dx=False,
                                            **kw0))]
        # the pooled TP form, on layer 0's whole eval output
        ops0_all, _ = prop.operands(params, 0, n, GP_SLOTS)
        with torch.no_grad():
            x1 = gk.gat_layer_fwd_plain(xin, *ops0_all, *args, heads,
                                        out_alpha=0.01)
        del ops0_all
        (ops1, _), (tops1, pe1) = shard(1), shard(1, True)
        kw1 = dict(tkw1, pe_pack=pe1)
        cases += [
            ("gat_layer_pooled_fwd", True, x1, ops1, None,
             lambda: gk.gat_layer_pooled_fwd(x1, *ops1, *args, local),
             lambda: gk.gat_layer_pooled_fwd_plain(x1, *ops1, *args,
                                                   local)),
            ("gat_layer_pooled_fwd_train", True, x1, tops1, pe1,
             lambda: gk.gat_layer_pooled_fwd_train(x1, *tops1, *args, local,
                                                   **kw1),
             lambda: gk.gat_layer_train_plain(x1, *tops1, *args, local,
                                              pooled=True, **kw1)),
            ("gat_layer_pooled_bwd", True, x1, tops1, pe1,
             lambda: gk.gat_layer_pooled_bwd(g1, x1, *tops1, *args, local,
                                             need_dx=True, need_dbias=False,
                                             **kw1),
             lambda: gk.gat_layer_bwd_plain(g1, x1, *tops1, *args, local,
                                            pooled=True, need_dx=True,
                                            **kw1))]
        for wrapper, pooled, x, ops, pe_pack, kernel, plain in cases:
            backward = wrapper.endswith("_bwd")
            name = wrapper + (f"[tp pooled {local} of {heads}{bf}]" if pooled
                              else tag)
            x2 = x.reshape(-1, x.shape[-1])
            if backward:
                d = torch.randn((x2.shape[0], ops[0].shape[1] + 2 * local),
                                device=device).to(x.dtype)
                matmul = lambda: x2.T @ d  # noqa: E731
            else:
                matmul = lambda: x2 @ ops[0]  # noqa: E731
            got, nums = measure(name, kernel, plain, backward, matmul,
                                bwd_passes(x) if backward
                                else fwd_passes(x, pooled))
            if backward:
                del d
                work = bwd_work(x, ops, pe_pack, g1 if pooled else g0, got,
                                ngp, nsib, local)
            else:
                nums["form"] = gk.fwd_form(x, pooled)
                work = fwd_work(pooled, x, ops, pe_pack, ngp, nsib, local,
                                got)
            records.append(gat_record(
                name, wrapper, path.replace("-tp", "-tp-pooled")
                if pooled else path, backward, x, ops[0], pe_pack, nums,
                work, REPLACES[wrapper], heads_local=local, heads=heads,
                dropout=drop if pe_pack is not None else 0.0,
                **({"need_dx": backward and pooled} if backward else {})))
            del got
            torch.cuda.empty_cache()
        # K7a at the shard: the store form and the stored K2 fed its weights
        records += store_entries(tag, path, False, xin, tops0, pe0, local,
                                 g0, kw0, 0.01, False, args)
        del xin, x1, g0
        torch.cuda.empty_cache()
    return records


def phase_gcn_kernels(batch: int, device,
                      path: str = "PGCN") -> list[dict]:
    """K5 against its plain versions at the PGCN shapes of config.mag.json
    (layer 0: 250 + 50 -> 500 with leaky_relu 0.01; the final layer:
    500 + 50 -> 500, no activation), 4096 egonets: the eval forward of both
    layers (pe term as z_bias), the train forward of both (feature and pe
    dropout at the config's feat_drop / out_drop, the pe path), and K5b of
    both (layer 0: need_dx off; the final layer: need_dx on); in float32
    (path PGCN) and in bf16 (x and W_h in bf16, the final layer fed the
    bf16 layer 0's output; reached by a direct call only, since PGCN runs
    float32 under any compute dtype, so its launches are the PGCN path's
    bf16 launches). Each entry, of either dtype, gives its form
    (`ck.form`: the valid-rows form at N = 64), its passes, the valid rows
    R and all B*N rows and, for the forwards, the packed rows; `products`
    (each product pass's TFLOP/s beside one torch.matmul of its shape in
    the entry's dtype, TF32 off); and beside them `parent_form`: the ms
    and passes of the two-pass form, the design before the valid-rows
    form, on the same inputs. With path "PGCN-concat" the forms pos_mode
    "concat" gives them, float32 only: the pe columns in x (layer 0 at 300
    input columns, its K5b with need_dx on; the final layer at 550), no
    z_bias and no pe path (entries "<wrapper>[<layer>, concat]")."""
    import torch
    from taxoexpan_torch.models.propagation import (concat_pos,
                                                    gcn_layer_operands,
                                                    slot_embeddings)
    from taxoexpan_torch.ops import gcn_kernels as ck
    from taxoexpan_torch.ops import star
    from taxoexpan_torch.weights import params_to
    _cfg, model = path_model(path)
    concat = path in CONCAT_PATHS
    gen = torch.Generator().manual_seed(SEED)
    prop = model.propagate
    params = params_to(model.init(gen), device)["propagate"]
    (din0, _, a0, drop0), (din1, _, a1, drop1) = [
        (spec[0] - (0 if concat else prop.pos_dim), *spec[1:])
        for spec in prop.layer_specs]
    x0, ngp, nsib = random_egonets(gen, batch, prop.layer_specs[0][0]
                                   - prop.pos_dim, device,
                                   model.expand_factor)
    n = x0.shape[1]

    def with_pos(x, l):
        """A layer's input: the pe columns appended under concat."""
        return concat_pos(x, params["pos_emb"][l]["emb"], GP_SLOTS) \
            if concat else x

    def operands(l, din, pe_dropout):
        if concat:
            return gcn_layer_operands(params["layers"][l], None, din, n)
        pe = slot_embeddings(params["pos_emb"][l]["emb"], GP_SLOTS, n)
        return gcn_layer_operands(params["layers"][l], pe, din, n,
                                  pe_dropout=pe_dropout)

    ops0, _ = operands(0, din0, False)
    ops1, _ = operands(1, din1, False)
    tops0, pe0 = operands(0, din0, True)
    tops1, pe1 = operands(1, din1, True)
    tkw0 = dict(pe_pack=pe0, seed=21, drop=drop0, alpha=a0)
    tkw1 = dict(pe_pack=pe1, seed=22, drop=drop1, alpha=a1)
    # incoming grads live on the valid slots: layer 1's dx and the
    # readout's grad are zero elsewhere
    valid = star.node_mask(ngp, nsib, GP_SLOTS, n)[..., None]
    dgen = torch.Generator(device=device).manual_seed(SEED)
    args = (ngp, nsib, GP_SLOTS)
    source = "taxoexpan_torch/ops/csrc/gcn.cu"
    bf16 = torch.bfloat16
    dx0 = concat     # layer 0's dx: on where its input has the pe columns
    records = []
    for dtype in (torch.float32,) if concat else (torch.float32, bf16):
        low = dtype == bf16
        # x and W_h in the layer's dtype; b, z_bias and the pe path float32
        cast = lambda ops: (ops[0].to(dtype), *ops[1:])  # noqa: E731
        o0, o1, t0, t1 = cast(ops0), cast(ops1), cast(tops0), cast(tops1)
        xa = with_pos(x0, 0).to(dtype)
        with torch.no_grad():
            yb = ck.gcn_layer_fwd_plain(xa, *o0, *args, a0)
            ybt = ck.gcn_layer_train_plain(xa, *t0, *args, **tkw0)
            xb, xbt = with_pos(yb, 1), with_pos(ybt, 1)
            # layer 0's leaky' jumps 100x at 0: the incoming grad is 0
            # within 1e-5 of the kink (of the float32 pre-activation the
            # kernel takes leaky' at), as for gat_layer_bwd
            pre = ck.gcn_star_plain(ck.gcn_projection_plain(
                xa, t0[0], t0[2], pe_pack=pe0, seed=21, drop=drop0),
                t0[1], *args)
            away = pre.abs() > 1e-5
            near_kink_share = 1.0 - float(away.double().mean())
            del pre
        g0 = ((torch.randn(ybt.shape, generator=dgen, device=device) * 1e-3)
              * valid * away).to(dtype)
        del away, yb, ybt
        g1 = ((torch.randn(xbt.shape[:2] + (prop.out_dim,), generator=dgen,
                           device=device) * 1e-2) * valid).to(dtype)
        cases = [
            ("gcn_layer_fwd", "layer0", xa, o0, None, a0,
             lambda: ck.gcn_layer_fwd(xa, *o0, *args, a0),
             lambda: ck.gcn_layer_fwd_plain(xa, *o0, *args, a0)),
            ("gcn_layer_fwd", "final", xb, o1, None, a1,
             lambda: ck.gcn_layer_fwd(xb, *o1, *args, a1),
             lambda: ck.gcn_layer_fwd_plain(xb, *o1, *args, a1)),
            ("gcn_layer_fwd_train", "layer0", xa, t0, pe0, a0,
             lambda: ck.gcn_layer_fwd_train(xa, *t0, *args, **tkw0),
             lambda: ck.gcn_layer_train_plain(xa, *t0, *args, **tkw0)),
            ("gcn_layer_fwd_train", "final", xbt, t1, pe1, a1,
             lambda: ck.gcn_layer_fwd_train(xbt, *t1, *args, **tkw1),
             lambda: ck.gcn_layer_train_plain(xbt, *t1, *args, **tkw1)),
            # the train step's backwards: layer 0 without dx (fixed input
            # features; with it under concat), neither needs d z_bias (zero
            # on the pe path and under concat)
            ("gcn_layer_bwd", "layer0", xa, t0, pe0, a0,
             lambda: ck.gcn_layer_bwd(g0, xa, *t0, *args, need_dx=dx0,
                                      need_dzb=False, **tkw0),
             lambda: ck.gcn_layer_bwd_plain(g0, xa, *t0, *args,
                                            need_dx=dx0, need_dzb=False,
                                            **tkw0)),
            ("gcn_layer_bwd", "final", xbt, t1, pe1, a1,
             lambda: ck.gcn_layer_bwd(g1, xbt, *t1, *args, need_dx=True,
                                      need_dzb=False, **tkw1),
             lambda: ck.gcn_layer_bwd_plain(g1, xbt, *t1, *args,
                                            need_dx=True, need_dzb=False,
                                            **tkw1)),
        ]
        for wrapper, layer, x, ops, pe_pack, alpha, kernel, plain in cases:
            name = f"{wrapper}[{layer}, bf16]" if low else \
                f"{wrapper}[{layer}, concat]" if concat else \
                f"{wrapper}[{layer}]"
            backward = wrapper == "gcn_layer_bwd"
            x2 = x.reshape(-1, x.shape[-1])
            w = ops[0]
            if backward:
                d = torch.randn((x2.shape[0], w.shape[1]), device=device,
                                dtype=dtype)
                matmul = lambda: x2.T @ d  # noqa: E731
                call = "torch.matmul(x.reshape(-1, Din).T, dz [B*N, Dout])"
            else:
                matmul = lambda: x2 @ w  # noqa: E731
                call = "torch.matmul(x.reshape(-1, Din), W_h)"
            if low:
                call += " in bf16"
            which = "gcn_bwd" if backward else "gcn_fwd"
            form = ck.form(x)
            got, nums = measure(name, kernel, plain, backward, matmul,
                                f"{which}:{form}")
            # the rows each form runs, its products' rates, and the
            # two-pass form on the same inputs beside it
            rows = int((ngp.clamp(0, GP_SLOTS) + 1
                        + nsib.clamp(0, n - GP_SLOTS - 1)).sum())
            all_rows = x.shape[0] * n
            nums.update(form=form, valid_rows=rows, all_rows=all_rows)
            if not backward:
                nums["packed_rows"] = packed_rows(ngp, nsib, GP_SLOTS, n)
            need_dx = (dx0 if layer == "layer0" else True) and backward
            run_rows = all_rows if form != "valid_rows" else \
                rows if backward else nums["packed_rows"]
            nums["products"] = gcn_product_rates(
                x, w.shape[1], pe_pack[0].shape[1] if pe_pack else 0,
                run_rows, nums["passes_ms"], backward, need_dx, form, alpha)
            with ck.use_form("two_pass"), torch.no_grad():
                nums["parent_form"] = {
                    "form": "two_pass",
                    "ms": time_ms(kernel, 5 if backward else 10),
                    "passes_ms": pass_split(kernel, f"{which}:two_pass")}
            kw = (tkw0 if layer == "layer0" else tkw1) \
                if wrapper != "gcn_layer_fwd" else {}
            if backward:
                del d
                nbytes, flops = gcn_bwd_work(x, ops, pe_pack,
                                             g0 if layer == "layer0" else g1,
                                             got, ngp, nsib, alpha)
            else:
                nums["star_alone"] = gcn_star_alone(name, x, ops, ngp, nsib,
                                                    alpha, kw)
                nbytes, flops = gcn_fwd_work(x, ops, pe_pack, ngp, nsib, got)
            rec = {"name": name, "wrapper": wrapper, "path": path,
                   "dtype": str(dtype).replace("torch.", ""),
                   "route": "cuda", "source": source,
                   "replaces": REPLACES[wrapper], "batch": batch,
                   "x_shape": list(x.shape), "w_shape": list(w.shape),
                   "alpha": alpha, "pe": pe_pack is not None,
                   "pos_mode": prop.pos_mode,
                   **({"need_dx": dx0 if layer == "layer0" else True}
                      if backward else {}),
                   **({"near_kink_share": near_kink_share}
                      if wrapper == "gcn_layer_bwd" and layer == "layer0"
                      else {}),
                   "dropout": kw.get("drop", 0.0),
                   **({"launch_key": f"{wrapper}[bf16]",
                       "reached_by": "a direct call (no model path: PGCN "
                                     "runs float32 under any compute "
                                     "dtype)"} if low else {}),
                   **nums,
                   # no single PyTorch call computes the star-GCN layer or
                   # its backward; one product alone is timed as a
                   # yardstick
                   "library_ms": None, "matmul_call": call,
                   **_bound(nbytes, flops, not low, bf16=low)}
            emit("kernel", **rec)
            records.append(rec)
            del got
            torch.cuda.empty_cache()
        del xa, xb, xbt, g0, g1
    return records


def phase_halo_kernels(device, num_nodes: int, batch: int,
                       dim: int) -> list[dict]:
    """K6 against its plain version on the card, in one process holding
    all P shards, at the data-parallel path's shapes and data: a
    [num_nodes, dim] float32 table row-partitioned over P = 2 and P = 4
    ranks, and one rank's request [P, cap] as `partition.plan_requests`
    makes it from its share of `batch` egonets x 64 node ids (n = batch *
    64 / P ids, cap = bucket_capacity(n, P)): each distinct id once in its
    owner's bucket, the dedup padding slots routed by position (most of
    them past the shard), the buckets' unused tail slot 0. A gather is
    exact: held to 0. The bound counts each distinct in-range (bucket,
    slot) row once, with ans and req. `library_ms`: one
    torch.index_select of the same rows from the unpartitioned table
    (ans [P * cap, D]; the out-of-range slots read row 0 there)."""
    import numpy as np
    import torch
    from taxoexpan_torch.ops import halo_kernels as hk
    from taxoexpan_torch.parallel.partition import (bucket_capacity,
                                                    plan_requests,
                                                    shard_table)
    gen = np.random.default_rng(SEED)
    table = gen.normal(size=(num_nodes, dim)).astype(np.float32)
    full = torch.from_numpy(table).to(device)
    # the dp path's egonets: config.mag.json's layout
    slots = GP_SLOTS + 1 + slot_args(load_config(PATHS["PGAT"][0]))[
        "expand_factor"]
    records = []
    for p in (2, 4):
        shards = [torch.from_numpy(s).to(device)
                  for s in shard_table(table, p)]
        rows = shards[0].shape[0]
        ids = gen.integers(0, num_nodes,
                           size=(batch // p, slots))
        n = ids.size
        cap = bucket_capacity(n, p)
        req = plan_requests(torch.from_numpy(ids).to(device), p).req
        req_np = req.cpu().numpy()
        in_range = (req_np >= 0) & (req_np < rows)
        distinct = sum(np.unique(req_np[j][in_range[j]]).size
                       for j in range(p))
        gids = torch.from_numpy(np.where(
            in_range, req_np.astype(np.int64) * p
            + np.arange(p)[:, None], 0).reshape(-1)).to(device)
        table_ptrs = hk.local_shards(shards)
        got = hk.halo_gather(table_ptrs, req)
        torch.cuda.synchronize()
        want = hk.halo_gather_plain(shards, req)
        err = float((got - want).abs().max())
        if err != 0.0 or not torch.isfinite(got).all():
            raise AssertionError(f"halo_gather P={p} differs from its plain "
                                 f"version by {err}")
        times = {"ms": time_ms(lambda: hk.halo_gather(table_ptrs, req), 20),
                 "plain_ms": time_ms(
                     lambda: hk.halo_gather_plain(shards, req), 5),
                 "library_ms": time_ms(
                     lambda: torch.index_select(full, 0, gids), 20)}
        n_in = int(in_range.sum())
        # each distinct row is read once; its repeats come from cache
        nbytes = distinct * dim * 4 + got.numel() * 4 + req.numel() * 4
        rec = {"name": f"halo_gather[P={p}]", "wrapper": "halo_gather",
               "path": "PGAT-dp", "route": "cuda",
               "source": "taxoexpan_torch/ops/csrc/halo.cu",
               "replaces": REPLACES["halo_gather"], "shards": p,
               "rows_per_shard": rows, "dim": dim, "ids_per_rank": n,
               "cap": cap, "in_range_slots": n_in,
               "distinct_in_range_rows": distinct,
               "out_of_range_slots": req.numel() - n_in,
               "max_abs_err": err, "atol": 0.0, **times,
               "library_call": "torch.index_select(table [V, D], 0, ids "
                               "[P * cap])",
               **_bound(nbytes, 0.0)}
        emit("kernel", **rec)
        records.append(rec)
        del got, want, shards, table_ptrs
        torch.cuda.empty_cache()
    return records


def phase_serving(device, num_nodes: int, n_novel: int, seed: int,
                  path: str = "PGAT") -> dict:
    """The user's entry points, `python -m taxoexpan_torch.test_fast` and
    `python -m taxoexpan_torch.infer` (their main functions, in this
    process), on a run directory as the JAX train.py leaves it: dataset
    pickle, config.json, checkpoint."""
    import numpy as np
    import torch
    from taxoexpan_torch import builders
    from taxoexpan_torch import infer as infer_cli
    from taxoexpan_torch import test_fast as test_fast_cli
    from taxoexpan_torch.data.synthetic import synthetic_taxonomy
    from taxoexpan_torch.evaluation.ranker import TaxonomyRanker
    from taxoexpan_torch.weights import (load_jax_checkpoint,
                                         restore_params, save_jax_checkpoint)

    cfg, model = path_model(path)
    wrappers = _eval_wrappers(path)
    in_dim = cfg["arch"]["args"]["in_dim"]
    taxonomy = synthetic_taxonomy(num_nodes=num_nodes, dim=in_dim, seed=seed)
    rng = np.random.default_rng(seed)
    held = np.asarray(taxonomy.test_node_ids[:n_novel], dtype=np.int64)
    novel = taxonomy.features[held] + 0.1 * rng.normal(
        size=(len(held), in_dim)).astype(np.float32)
    with tempfile.TemporaryDirectory() as tmp:
        run = Path(tmp)
        taxonomy.save(str(run / "synthetic.pickle.bin"))
        for loader in ("train_data_loader", "validation_data_loader",
                       "test_data_loader"):
            cfg[loader]["args"].update(
                data_path=str(run / "synthetic.pickle.bin"),
                **slot_args(cfg))
        (run / "config.json").write_text(json.dumps(cfg))
        ckpt = str(run / "model_random.ckpt")
        save_jax_checkpoint(ckpt, model.init(
            torch.Generator().manual_seed(seed)), cfg)
        with open(run / "novel.txt", "w") as fout:
            for i, row in enumerate(novel):
                fout.write(f"novel term {i}\t{' '.join(map(str, row))}\n")

        # ---- the main path, with the launch counters around it
        reset_counters()
        torch.cuda.reset_peak_memory_stats(device)
        t0 = time.time()
        metrics = test_fast_cli.main(test_fast_cli.parse_args(
            ["-r", ckpt, "-c", str(run / "case.tsv")]))
        t1 = time.time()
        preds = infer_cli.main(infer_cli.parse_args(
            ["-r", ckpt, "-t", str(run / "novel.txt"),
             "-s", str(run / "predictions.tsv")]))
        torch.cuda.synchronize()
        t2 = time.time()
        launches = path_launches(path, wrappers)

        # ---- checks
        for name in wrappers:
            if launches[name] <= 0:
                raise AssertionError(f"the serving path never launched "
                                     f"{name}")
        bad = {k: v for k, v in metrics.items() if not np.isfinite(v)}
        if bad:
            raise AssertionError(f"non-finite metrics {bad}")
        n_cases = len((run / "case.tsv").read_text().splitlines())
        n_pred_lines = len((run / "predictions.tsv").read_text()
                           .splitlines())
        state = load_jax_checkpoint(ckpt)
    test_cfg = dict(cfg["test_data_loader"]["args"], sampling_mode=0)
    sampler = builders.build_sampler(taxonomy, test_cfg, "test")
    if n_cases != 1 + len(sampler.node_list) or n_pred_lines != 1 + n_novel:
        raise AssertionError(f"case study has {n_cases} lines, predictions "
                             f"{n_pred_lines}")
    if len(preds) != n_novel or any(
            len(row) != 5 or not 0 <= min(row) <= max(row) < num_nodes
            for row in preds):
        raise AssertionError(f"malformed predictions {preds}")

    # the card's graph embeddings against the CPU plain path
    params = restore_params(state, model)
    ranker = TaxonomyRanker(model, params, sampler, sampler.node_features,
                            device=device)
    t3 = time.time()
    hg = ranker.encode_all_anchors()
    encode_s = time.time() - t3
    if not torch.isfinite(hg).all():
        raise AssertionError("non-finite graph embeddings")
    node_ids, ngp, nsib = (a[:256] for a in ranker._anchor_arrays())
    with torch.no_grad():
        ngp_t, nsib_t = torch.from_numpy(ngp), torch.from_numpy(nsib)
        feats = model.gather_feats(torch.from_numpy(sampler.node_features),
                                   torch.from_numpy(node_ids).long(),
                                   ngp_t, nsib_t)
        want = model.encode(params, feats, ngp_t, nsib_t)
    bf16 = path in BF16_PATHS
    # bf16: layer outputs may round to neighbouring bf16 values (one ulp,
    # 2**-8 relative) on the card and the CPU; through the next layer's sum
    # over 2000 or 3600 inputs that moves hg by far less than 2**-7 of its
    # largest value
    hg_check = compare("hg (card vs CPU plain path, first 256 anchors)",
                       hg[:256].cpu(), want,
                       **({"rtol": BF16_RTOL,
                           "atol": BF16_RTOL * float(want.abs().max())}
                          if bf16 else {}))
    if model.aux_heads and "aux" not in state["params"]:
        raise AssertionError("the MTL checkpoint has no aux params")
    bf16_vs_f32 = None
    if bf16:     # test_bf16.py's contract against the float32 model
        bf16_vs_f32 = bf16_scores_vs_f32(cfg, params, sampler, hg[:256],
                                         device)
    res = {"path": path, "nodes": taxonomy.num_nodes, "dim": in_dim,
           "candidates": len(ranker.candidates),
           "queries": len(sampler.node_list),
           "encode_chunk": ranker.encode_chunk, "metrics": metrics,
           "test_fast_s": t1 - t0, "infer_s": t2 - t1, "encode_s": encode_s,
           "launches": launches, "novel_queries": n_novel,
           "predictions_head": preds[:2], "hg_vs_cpu": hg_check,
           **({"scores_vs_float32": bf16_vs_f32} if bf16 else {})}
    emit("serving", **res)
    return res


# MAG-Full, the reference's largest operating point (about 355k nodes,
# evaluated over the whole catalog in 30000-anchor chunks; VERDICT.md:34,
# :102-110): reference_scale_run's v2 data with only the node count raised
MAG_FULL_DATA = dict(num_nodes=355000, dim=250, max_children=40, noise=1.0,
                     seed=42)
MAG_FULL_CHUNK = 30000


@contextlib.contextmanager
def captured_rankers():
    """Every TaxonomyRanker made in the block, in the list the block gets."""
    from taxoexpan_torch.evaluation.ranker import TaxonomyRanker
    init, kept = TaxonomyRanker.__init__, []

    def keep(self, *args, **kwargs):
        init(self, *args, **kwargs)
        kept.append(self)
    TaxonomyRanker.__init__ = keep
    try:
        yield kept
    finally:
        TaxonomyRanker.__init__ = init


@contextlib.contextmanager
def timed_calls(owner, name: str):
    """The wall seconds of each call of `owner.name` in the block, in the
    list the block gets."""
    fn, seconds = getattr(owner, name), []

    def timed(*args, **kwargs):
        t0 = time.time()
        try:
            return fn(*args, **kwargs)
        finally:
            seconds.append(time.time() - t0)
    setattr(owner, name, timed)
    try:
        yield seconds
    finally:
        setattr(owner, name, fn)


def phase_mag_full(device) -> dict:
    """Serving at MAG-Full scale through the entry points: a
    `synthetic_taxonomy_v2` of MAG_FULL_DATA (355,000 nodes, dim 250;
    319,446 train nodes, the candidates; 17,777 test queries; max_parents
    "auto" gives 1 grandparent slot, N = 52), configs/config.mag.json as
    published (float32 PGAT, WMR, BIM; path PGAT) with random weights from
    seed 0 in the JAX checkpoint format, then `taxoexpan_torch.test_fast
    -b 30000` (every test query against the whole catalog) and
    `taxoexpan_torch.infer -b 30000` (N_NOVEL novel terms against every
    node of the test working graph), the launch counters set to 0 just
    before and read after each: K1 and K3 in eval form launched
    ceil(candidates / 30000) times by each. Records the stages' wall clocks
    (generation, pickling, the CLIs' data load and samplers, anchor arrays,
    encode, query prep, rank), the peak device memory of each CLI and the
    process's host max RSS; checks finite metrics, the case study's and
    the predictions' lines, and the first 256 anchors' graph embeddings
    against the CPU plain path."""
    import math
    import resource
    import numpy as np
    import torch
    from taxoexpan_torch import builders
    from taxoexpan_torch import infer as infer_cli
    from taxoexpan_torch import test_fast as test_fast_cli
    from taxoexpan_torch.data.synthetic import synthetic_taxonomy_v2
    from taxoexpan_torch.weights import (load_jax_checkpoint,
                                         restore_params, save_jax_checkpoint)

    wrappers = _eval_wrappers("PGAT")
    stages = {}
    t0 = time.time()
    taxonomy = synthetic_taxonomy_v2(**MAG_FULL_DATA)
    stages["generation"] = time.time() - t0
    # the params do not depend on the slot counts
    cfg, model = path_model("PGAT")
    dim = MAG_FULL_DATA["dim"]
    rng = np.random.default_rng(SEED)
    held = np.asarray(taxonomy.test_node_ids[:N_NOVEL], dtype=np.int64)
    novel = taxonomy.features[held] + 0.1 * rng.normal(
        size=(len(held), dim)).astype(np.float32)
    with tempfile.TemporaryDirectory() as tmp:
        run = Path(tmp)
        data = run / "mag_full.pickle.bin"
        t0 = time.time()
        taxonomy.save(str(data))
        stages["pickling"] = time.time() - t0
        for loader in ("train_data_loader", "validation_data_loader",
                       "test_data_loader"):
            cfg[loader]["args"]["data_path"] = str(data)
        (run / "config.json").write_text(json.dumps(cfg))
        ckpt = str(run / "model_random.ckpt")
        save_jax_checkpoint(ckpt, model.init(
            torch.Generator().manual_seed(SEED)), cfg)
        with open(run / "novel.txt", "w") as fout:
            for i, row in enumerate(novel):
                fout.write(f"novel term {i}\t{' '.join(map(str, row))}\n")
        del taxonomy

        # ---- the main path, with the launch counters around each CLI
        runs = {}
        for cli, argv in (
                ("test_fast", ["-r", ckpt, "-b", str(MAG_FULL_CHUNK), "-c",
                               str(run / "case.tsv")]),
                ("infer", ["-r", ckpt, "-b", str(MAG_FULL_CHUNK), "-t",
                           str(run / "novel.txt"), "-s",
                           str(run / "predictions.tsv")])):
            module = test_fast_cli if cli == "test_fast" else infer_cli
            reset_counters()
            torch.cuda.reset_peak_memory_stats(device)
            t0 = time.time()
            with captured_rankers() as rankers, \
                    timed_calls(builders, "build_taxonomy") as t_load, \
                    timed_calls(builders, "build_sampler") as t_sampler:
                out = module.main(module.parse_args(argv))
            torch.cuda.synchronize()
            ranker = rankers[0]
            runs[cli] = {
                "out": out, "seconds": time.time() - t0,
                "candidates": len(ranker.candidates),
                "launches": path_launches(
                    "PGAT", wrappers, slots=ranker.sampler.max_parents + 1
                    + ranker.sampler.expand_factor),
                "max_memory_allocated_bytes":
                    torch.cuda.max_memory_allocated(device),
                "stages": {"data_load": sum(t_load),
                           "sampler": sum(t_sampler), **ranker.timing}}
            if cli == "test_fast":
                test_ranker = ranker
            del ranker, rankers[:]
        metrics, preds = runs["test_fast"]["out"], runs["infer"]["out"]

        # ---- checks: each CLI encodes its candidates in whole chunks
        queries = len(test_ranker.sampler.node_list)
        expected = {cli: math.ceil(runs[cli]["candidates"] / MAG_FULL_CHUNK)
                    for cli in runs}
        for cli in runs:
            for name in wrappers:
                got = runs[cli]["launches"][name]
                if got != expected[cli]:
                    raise AssertionError(
                        f"MAG-Full {cli} launched {name} {got} times, "
                        f"expected {expected[cli]}")
        bad = {k: v for k, v in metrics.items() if not np.isfinite(v)}
        if bad:
            raise AssertionError(f"non-finite MAG-Full metrics {bad}")
        n_cases = len((run / "case.tsv").read_text().splitlines())
        n_pred_lines = len((run / "predictions.tsv").read_text()
                           .splitlines())
        if n_cases != 1 + queries or n_pred_lines != 1 + N_NOVEL:
            raise AssertionError(f"MAG-Full case study has {n_cases} lines, "
                                 f"predictions {n_pred_lines}")
        if len(preds) != N_NOVEL or any(
                len(row) != 5 or not 0 <= min(row) <= max(row)
                < MAG_FULL_DATA["num_nodes"] for row in preds):
            raise AssertionError(f"malformed MAG-Full predictions {preds}")
        state = load_jax_checkpoint(ckpt)
    # the card's graph embeddings (the first chunk's first rows) against
    # the CPU plain path
    sampler, model = test_ranker.sampler, test_ranker.model
    params = restore_params(state, model)
    hg = test_ranker.encode_all_anchors()
    node_ids, ngp, nsib = (a[:256] for a in test_ranker._anchor_arrays())
    with torch.no_grad():
        ngp_t, nsib_t = torch.from_numpy(ngp), torch.from_numpy(nsib)
        feats = model.gather_feats(torch.from_numpy(sampler.node_features),
                                   torch.from_numpy(node_ids).long(),
                                   ngp_t, nsib_t)
        want = model.encode(params, feats, ngp_t, nsib_t)
    hg_check = compare("MAG-Full hg (card vs CPU plain path, first 256 "
                       "anchors)", hg[:256].cpu(), want)
    if not bool(torch.isfinite(hg).all()):
        raise AssertionError("non-finite MAG-Full graph embeddings")
    res = {"card": nvidia_smi_line(), **MAG_FULL_DATA,
           "config": "configs/config.mag.json (float32)",
           "encode_chunk": MAG_FULL_CHUNK, "queries": queries,
           "candidates": {cli: runs[cli]["candidates"] for cli in runs},
           "max_parents": sampler.max_parents,
           "slots": sampler.max_parents + 1 + sampler.expand_factor,
           "metrics": metrics, "predictions_head": preds[:2],
           "stages_s": {"generation": stages["generation"],
                        "pickling": stages["pickling"],
                        **{f"{cli} {k}": v for cli in runs
                           for k, v in runs[cli]["stages"].items()},
                        **{f"{cli} in all": runs[cli]["seconds"]
                           for cli in runs}},
           "launches": {cli: runs[cli]["launches"] for cli in runs},
           "expected_launches": expected,
           "max_memory_allocated_bytes": {
               cli: runs[cli]["max_memory_allocated_bytes"] for cli in runs},
           "host_max_rss_kib": resource.getrusage(
               resource.RUSAGE_SELF).ru_maxrss,
           "hg_vs_cpu": hg_check}
    del test_ranker, hg
    torch.cuda.empty_cache()
    emit("mag_full", **res)
    return res


def phase_mag_full_kernels(device) -> list[dict]:
    """K1 and K3 in eval form at the shapes phase_mag_full gives them: one
    MAG_FULL_CHUNK encode chunk of config.mag.json's float32 PGAT (30000
    egonets, 1 grandparent slot, N = 52; layer 0 250 + 50 -> 4 x 500, the
    pooled final layer 2000 + 50 -> 1 x 500), random egonets from seed 0.
    Each egonet's output depends on its own rows only, so the kernel's
    whole-chunk output is held to the plain version chunk by chunk (4096
    egonets a call: the plain version's intermediates at 30000 egonets
    take tens of GB); `plain_ms` is the sum of those calls."""
    import torch
    from taxoexpan_torch import builders
    from taxoexpan_torch.ops import gat_kernels as gk
    from taxoexpan_torch.weights import params_to
    cfg = load_config(PATHS["PGAT"][0])
    gp = 1                       # max_parents "auto" on MAG_FULL_DATA
    model = builders.build_model(cfg["arch"], max_parents=gp,
                                 expand_factor=slot_args(cfg)[
                                     "expand_factor"])
    gen = torch.Generator().manual_seed(SEED)
    prop = model.propagate
    params = params_to(model.init(gen), device)["propagate"]
    batch = MAG_FULL_CHUNK
    x0, ngp, nsib = random_egonets(gen, batch, prop.layer_specs[0][0]
                                   - prop.pos_dim, device,
                                   model.expand_factor, gp=gp)
    n = x0.shape[1]
    ops0, _ = prop.operands(params, 0, n, gp)
    ops1, _ = prop.operands(params, 1, n, gp)
    h0, h1 = prop.layer_specs[0][2], prop.layer_specs[1][2]
    step = BATCH
    with torch.no_grad():
        x1 = gk.gat_layer_fwd(x0, *ops0, ngp, nsib, gp, h0, out_alpha=0.01)
    records = []
    for wrapper, pooled, x, ops, heads, alpha in (
            ("gat_layer_fwd", False, x0, ops0, h0, 0.01),
            ("gat_layer_pooled_fwd", True, x1, ops1, h1, None)):
        kw = {} if pooled else {"out_alpha": alpha}
        kernel_fn = getattr(gk, wrapper)
        plain_fn = getattr(gk, wrapper + "_plain")

        def kernel():
            return kernel_fn(x, *ops, ngp, nsib, gp, heads, **kw)

        def plain_chunks():
            return [plain_fn(x[i:i + step], *ops, ngp[i:i + step],
                             nsib[i:i + step], gp, heads, **kw)
                    for i in range(0, batch, step)]
        with torch.no_grad():
            got = kernel()
            torch.cuda.synchronize()
            err = {"max_abs_err": 0.0, "max_rel_err": 0.0}
            for i, want in zip(range(0, batch, step), plain_chunks()):
                res = compare(f"{wrapper}[mag_full] egonets {i}-"
                              f"{min(i + step, batch)}", got[i:i + step],
                              want)
                for k in err:
                    err[k] = max(err[k], res[k])
                del want
            nbytes, flops = fwd_work(pooled, x, ops, None, ngp, nsib, heads,
                                     got, gp=gp)
            x2 = x.reshape(-1, x.shape[-1])
            nums = {**err, "rtol": RTOL, "atol": ATOL,
                    "form": gk.fwd_form(x, pooled),
                    "ms": time_ms(kernel, 3),
                    "plain_ms": time_ms(lambda: plain_chunks(), 1),
                    "plain_call": f"the plain version in {step}-egonet "
                                  "chunks, summed",
                    "matmul_ms": time_ms(lambda: x2 @ ops[0], 3),
                    "passes_ms": pass_split(kernel, fwd_passes(x, pooled)),
                    # both forms at N = 52: the fused form computes 64
                    # rows a warpgroup for 52
                    "parent_form": two_pass_form(
                        f"{wrapper}[mag_full]", kernel, got, iters=3)}
        rec = gat_record(f"{wrapper}[mag_full]", wrapper, "MAG-Full", False,
                         x, ops[0], None, nums, (nbytes, flops),
                         REPLACES[wrapper], max_parents=gp, slots=n)
        records.append(rec)
        del got
        torch.cuda.empty_cache()
    del x0, x1
    torch.cuda.empty_cache()
    return records


def bf16_scores_vs_f32(cfg: dict, params: dict, sampler, hg16, device,
                       queries: int = 64) -> dict:
    """The bf16 model's scores (graph embeddings hg16 of the first anchors,
    against the first test queries) beside the float32 model's from the
    same checkpoint on the card: within BF16_SCORE_REL of the float32
    scores' mean |score| (tests/test_bf16.py's contract)."""
    import numpy as np
    import torch
    from taxoexpan_torch import builders
    from taxoexpan_torch.evaluation.ranker import TaxonomyRanker
    args = {k: v for k, v in cfg["arch"]["args"].items()
            if k != "compute_dtype"}
    m32 = builders.build_model({"args": args},
                               max_parents=sampler.max_parents,
                               expand_factor=sampler.expand_factor)
    ranker = TaxonomyRanker(m32, params, sampler, sampler.node_features,
                            device=device)
    hg32 = ranker.encode_all_anchors()[:hg16.shape[0]]
    qf = torch.from_numpy(np.asarray(
        sampler.node_features[np.asarray(sampler.node_list[:queries])],
        dtype=np.float32)).to(device)
    dev_params = ranker.params
    with torch.no_grad():
        s16 = m32.match_all(dev_params, hg16.to(device), qf)
        s32 = m32.match_all(dev_params, hg32, qf)
    scale = float(s32.abs().mean())
    rel = float((s16 - s32).abs().max()) / scale
    if not rel < BF16_SCORE_REL:
        raise AssertionError(f"bf16 scores differ from the float32 model's "
                             f"by {rel} of its mean |score|")
    return {"max_abs_diff_over_mean_abs_f32": rel, "limit": BF16_SCORE_REL,
            "anchors": int(hg16.shape[0]), "queries": int(qf.shape[0])}


def compare_train_step(device, cfg: dict, taxonomy, params: dict,
                       groups: int = 4, bf16: bool = False) -> dict:
    """One train step (forward, loss, grads, AMSGrad update) on the card
    against the same step on the CPU plain path: same params, batch, step
    index (so the same dropout seeds and masks) and switches, full width.

    Tolerances: loss 1e-4 relative; each grad to 1e-3 of its leaf's largest
    value plus 1e-6 of the step's largest grad (float32 through two layers,
    sums over 8192 slots in another order; a leaf whose grad vanishes
    analytically, such as the final layer's attn_r wherever both sibling
    logits share a sign, holds rounding noise only); each updated param to
    1e-5 where its grad is at least max(1e-6, 1e-3 of the leaf's largest),
    and within 2 * lr elsewhere: AMSGrad's first step
    lr * g / (|g| + 1e-8) turns float32 rounding of a near-zero grad into
    any step in [-lr, lr]. With `bf16` (a bf16 model): the loss to 1e-3
    relative and each grad to 2**-6 of its leaf's largest value: the layers'
    outputs and their weight grads are rounded to bf16 on both sides from
    float32 values summed in another order, so elements may land one bf16
    ulp (2**-8 relative) apart, and what follows them moves by about as
    much."""
    import numpy as np
    import torch
    from taxoexpan_torch import builders
    from taxoexpan_torch.training.trainer import Trainer, batch_to
    from taxoexpan_torch.tree import tree_leaves
    train_cfg = dict(cfg["train_data_loader"]["args"], batch_size=groups,
                     num_workers=0)
    sampler = builders.build_sampler(taxonomy, train_cfg, "train")
    model = builders.build_model(cfg["arch"], max_parents=sampler.max_parents,
                                 expand_factor=sampler.expand_factor)
    batch = next(iter(builders.build_loader(sampler, train_cfg)))
    out = []
    with tempfile.TemporaryDirectory() as tmp:
        for dev in (device, torch.device("cpu")):
            opt = builders.build_optimizer_from_config(cfg["optimizer"],
                                                       cfg["trainer"])
            tr = Trainer(model, params, opt, opt.init(params),
                         loss_name=cfg["loss"], metric_names=cfg["metrics"],
                         feature_table=sampler.node_features,
                         train_loader=None, save_dir=tmp, device=dev)
            t0 = time.time()
            loss, grads = tr.train_step(batch_to(batch, dev), 12345,
                                        return_grads=True)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            out.append((float(loss), time.time() - t0,
                        [g.cpu() for g in tree_leaves(grads)],
                        [q.cpu() for q in tree_leaves(tr.params)]))
    (l_gpu, s_gpu, g_gpu, p_gpu), (l_cpu, s_cpu, g_cpu, p_cpu) = out
    lr = float(cfg["optimizer"]["args"]["lr"])
    loss_rtol, grad_rel = (1e-3, 2 ** -6) if bf16 else (1e-4, 1e-3)
    if not np.isfinite(l_gpu) or abs(l_gpu - l_cpu) > loss_rtol * abs(l_cpu):
        raise AssertionError(f"train step loss: card {l_gpu}, CPU {l_cpu}")
    worst_g = grads_vs_reference([g.numpy() for g in g_gpu],
                                 [g.numpy() for g in g_cpu], grad_rel,
                                 "train step")
    worst_p = 0.0
    n_tiny = n_all = 0
    step_max = max(float(g.abs().max()) for g in g_cpu)
    for gc, pg, pc in zip(g_cpu, p_gpu, p_cpu):
        scale = float(gc.abs().max())
        tiny = gc.abs() < max(1e-6, 1e-3 * scale)
        dp = (pg - pc).abs()
        if bool((dp[~tiny] > 1e-5).any()) or bool((dp[tiny] > 2 * lr).any()):
            raise AssertionError(f"train step params differ by "
                                 f"{float(dp.max())}")
        if bool((~tiny).any()):
            worst_p = max(worst_p, float(dp[~tiny].max()))
        n_tiny += int(tiny.sum())
        n_all += tiny.numel()
    return {"egonets": int(batch.labels.size), "loss_card": l_gpu,
            "loss_cpu": l_cpu, "loss_rtol": loss_rtol,
            "grad_tol_rel_to_leaf_max": grad_rel, "step_s_card_first": s_gpu,
            "step_s_cpu": s_cpu, "max_grad_err_rel_to_leaf_max": worst_g,
            "largest_grad": step_max,
            "max_param_err_well_conditioned": worst_p,
            "near_zero_grad_share": n_tiny / max(n_all, 1)}


def grads_vs_reference(got: list, want: list, rel: float,
                       what: str) -> float:
    """Each leaf's grad in `got` (numpy arrays) within `rel` of that leaf's
    largest value in `want` plus 1e-6 of the largest of all: the float32
    rule `grad_rel` = 1e-3 of `compare_train_step` (a leaf whose grad
    vanishes analytically holds rounding noise only). Returns the worst
    difference relative to its leaf's scale; raises past the rule."""
    import numpy as np
    step_max = max(float(np.abs(w).max()) for w in want)
    worst = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        scale = float(np.abs(w).max())
        dg = float(np.abs(g - w).max())
        if dg > rel * scale + 1e-6 * step_max:
            raise AssertionError(f"{what}: grad leaf {i} differs by {dg} "
                                 f"(leaf max {scale}, step max {step_max})")
        worst = max(worst, dg / max(scale, 1e-6 * step_max))
    return worst


@contextlib.contextmanager
def pre_repair_syncs():
    """The two host-to-device copies of a train step as they were before
    their repair, for the before / after measurements: AMSGrad's bias
    corrections as float32 tensors on the host copied to the params'
    device, and the slot codes of the position embeddings copied from a
    host array (each a blocking copy, a layer)."""
    import torch
    from taxoexpan_torch.models import propagation
    from taxoexpan_torch.training import optim

    def corrections(count, device):
        return tuple((1 - torch.tensor(b, dtype=torch.float32) ** count)
                     .to(device) for b in (optim.B1, optim.B2))

    def slot_embeddings(emb, p_slots, n):
        return emb[torch.as_tensor(propagation.star_slot_positions(
            p_slots, n), device=emb.device)]
    repaired = optim.bias_corrections, propagation.slot_embeddings
    optim.bias_corrections = corrections
    propagation.slot_embeddings = slot_embeddings
    try:
        yield
    finally:
        optim.bias_corrections, propagation.slot_embeddings = repaired


def step_syncs(trainer, batch, step_idx: int) -> dict:
    """The host syncs one train step makes: the step run under
    torch.cuda.set_sync_debug_mode("warn"), every synchronizing operation
    counted with the source line that issued it."""
    import warnings

    import torch
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            trainer.train_step(batch, step_idx)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = [w for w in caught if "synchroniz" in str(w.message)]
    where: dict = {}
    for w in syncs:
        key = f"{Path(w.filename).name}:{w.lineno}"
        where[key] = where.get(key, 0) + 1
    return {"count": len(syncs), "where": where}


def sync_repair(trainer, run: Path) -> dict:
    """A train step's host-to-device copies repaired (AMSGrad's bias
    corrections and the slot codes made on the card) against their form
    before the repair (`pre_repair_syncs`), on the trained trainer, each
    in turn:
    the host syncs of one train step (`step_syncs`), the median step of an
    epoch with `trainer.step_timing`'s sync after each step, and the
    device's idle share in the profiler window of an epoch without it."""
    import numpy as np
    from taxoexpan_torch.training.trainer import batch_to
    batch = batch_to(next(iter(trainer.train_loader)), trainer.device)
    # the first step under sync debug mode in a process has met a one-time
    # sync in torch's own code: counted apart
    out = {"first_step_in_process": step_syncs(trainer, batch, 0)}
    for label, form in (("before", pre_repair_syncs),
                        ("after", contextlib.nullcontext)):
        with form():
            syncs = step_syncs(trainer, batch, 0)
            trainer.step_timing, trainer.profile_dir = True, None
            step_ms = trainer._train_epoch(3)["step_ms"]
            trainer.step_timing = False
            trainer.profile_dir = run / f"profile_{label}"
            trainer._train_epoch(1)
        window = trace_split(trainer.profile_dir / "trace.json")
        out[label] = {"syncs": syncs, "step_ms": step_ms,
                      "median_step_ms": float(np.median(step_ms)),
                      "window_device_idle_share": window["device_idle_share"],
                      "window_wall_ms": window["wall_ms"],
                      "window_device_busy_ms": window["device_busy_ms"]}
    if out["after"]["syncs"]["count"]:
        raise AssertionError(f"the repaired train step still syncs: "
                             f"{out['after']['syncs']}")
    return out


def trace_split(path: Path) -> dict:
    """A profiler window's Chrome trace read back: its wall ms (the span of
    its events, host and device), the device-busy ms (the union of its
    kernels' intervals), the device's idle share (1 - busy / wall), and
    the device operations with the most total time."""
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X" and "dur" in e]
    kernels = sorted((e for e in events if e.get("cat") == "kernel"),
                     key=lambda e: e["ts"])
    if not kernels:
        raise AssertionError(f"the profiler trace {path} holds no kernel")
    t0 = min(e["ts"] for e in events)
    t1 = max(e["ts"] + e["dur"] for e in events)
    busy, end = 0.0, float("-inf")
    for e in kernels:            # the union of the kernels' intervals
        a, b = e["ts"], e["ts"] + e["dur"]
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    by_name: dict = {}
    for e in kernels:
        calls, total = by_name.get(e["name"], (0, 0.0))
        by_name[e["name"]] = (calls + 1, total + e["dur"])
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    return {"wall_ms": (t1 - t0) / 1e3, "device_busy_ms": busy / 1e3,
            "device_idle_share": 1.0 - busy / (t1 - t0),
            "kernel_launches": len(kernels),
            "top_device_ops": [{"name": name[:120], "calls": calls,
                                "ms": total / 1e3}
                               for name, (calls, total) in top]}


def trainer_runtime(trainer, run: Path) -> dict:
    """What the checkpoint writer and the validation prefetch take off an
    epoch's foreground on the card, on the trained trainer: the sampled
    validation inline (sampled and staged, then scored) against prefetched
    (staged by the prefetch thread beforehand, as during a train epoch);
    a checkpoint in the foreground (readback and both files, the form
    before the writer thread) against the background form's foreground
    (clones and the thread's start), and the wait for its write."""
    import torch
    from taxoexpan_torch.weights import to_numpy

    def timed(fn) -> float:
        torch.cuda.synchronize()
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        return time.time() - t0

    valid_inline_s = timed(lambda: trainer._valid_epoch(1))
    trainer._valid_prefetch = trainer._start_valid_prefetch()
    trainer._valid_prefetch[0].join()
    valid_prefetched_s = timed(lambda: trainer._valid_epoch(1))
    kw = dict(epoch=1, monitor_best=trainer.mnt_best, config=trainer.config,
              scheduler_state=None)
    checkpoint_foreground_s = timed(lambda: trainer._write_checkpoint(
        [run / "fg-epoch.ckpt", run / "fg-best.ckpt"],
        *to_numpy([trainer.params, trainer.opt_state]), **kw))
    checkpoint_background_s = timed(
        lambda: trainer._save_checkpoint(99, save_best=True))
    t0 = time.time()
    trainer._join_ckpt()
    return {"valid_inline_s": valid_inline_s,
            "valid_prefetched_s": valid_prefetched_s,
            "valid_batches": len(trainer.valid_loader),
            "checkpoint_foreground_s": checkpoint_foreground_s,
            "checkpoint_background_s": checkpoint_background_s,
            "checkpoint_background_write_s": time.time() - t0}


def phase_training(device, num_nodes: int, epochs: int, seed: int,
                   path: str = "PGAT") -> dict:
    """`python -m taxoexpan_torch.train` (its main, in this process) on a
    synthetic run directory at the path's full width, with its switches.
    On PROFILE_PATH the trainer's profiler window is on (batches
    PROFILE_WINDOW of epoch 1, `Trainer(profile_dir=)`), epoch 1 runs the
    sampled validation (with its prefetch) and epoch 2 the full one; its
    trace is read back (`trace_split`), a second window is traced over
    one more epoch without the per-step synchronisation of
    `trainer.step_timing`, and `trainer_runtime` measures the checkpoint
    writer and the prefetch."""
    import numpy as np
    import torch
    from taxoexpan_torch import test_fast as test_fast_cli
    from taxoexpan_torch import train as train_cli
    from taxoexpan_torch.data.synthetic import synthetic_taxonomy
    from taxoexpan_torch.reference_scale_run import epoch_split
    from taxoexpan_torch.tree import tree_leaves
    from taxoexpan_torch.weights import load_jax_checkpoint, restore_params

    cfg, model = path_model(path)
    wrappers, required = _train_wrappers(path)
    env = PATHS[path][2]
    in_dim = cfg["arch"]["args"]["in_dim"]
    taxonomy = synthetic_taxonomy(num_nodes=num_nodes, dim=in_dim, seed=seed)
    with tempfile.TemporaryDirectory() as tmp:
        run = Path(tmp)
        taxonomy.save(str(run / "synthetic.pickle.bin"))
        for loader in ("train_data_loader", "validation_data_loader",
                       "test_data_loader"):
            cfg[loader]["args"].update(
                data_path=str(run / "synthetic.pickle.bin"),
                **slot_args(cfg))
        cfg["trainer"].update(epochs=epochs, save_dir=str(run / "saved"),
                              full_validation_every=1, tensorboardX=False,
                              step_timing=True)
        profile = path == PROFILE_PATH
        if profile:
            cfg["trainer"]["full_validation_every"] = 2
        (run / "config.json").write_text(json.dumps(cfg))
        config = train_cli.parse_args(["-c", str(run / "config.json")])
        trainers = []
        trainer_cls = train_cli.Trainer

        class ProfiledTrainer(trainer_cls):
            """The CLI's trainer with the profiler window on, kept."""

            def __init__(self, *args, **kwargs):
                super().__init__(*args, profile_dir=run / "profile",
                                 **kwargs)
                self._profile_window = PROFILE_WINDOW
                trainers.append(self)

        # ---- the main path, with the launch counters around it
        reset_counters()
        torch.cuda.reset_peak_memory_stats(device)
        t0 = time.time()
        if profile:
            train_cli.Trainer = ProfiledTrainer
        try:
            with switches(env):
                log = train_cli.main(config)
        finally:
            train_cli.Trainer = trainer_cls
        torch.cuda.synchronize()
        train_s = time.time() - t0
        peak_bytes = torch.cuda.max_memory_allocated(device)
        launches = path_launches(path, wrappers)

        # ---- checks
        for name in required:
            if launches[name] <= 0:
                raise AssertionError(f"training never launched {name}")
        if not np.isfinite(log["loss"]):
            raise AssertionError(f"non-finite training loss {log['loss']}")
        best = config.save_dir / "model_best.ckpt"
        last = config.save_dir / f"checkpoint-epoch{epochs}.ckpt"
        if not (best.exists() and last.exists()):
            raise AssertionError(f"checkpoints missing in {config.save_dir}")
        state = load_jax_checkpoint(last)
        if model.aux_heads and "aux" not in state["params"]:
            raise AssertionError("the MTL checkpoint has no aux params")
        trained = restore_params(state, model)
        init = model.init(torch.Generator().manual_seed(cfg.get("seed", 0)))
        changed = max(float((a - b).abs().max()) for a, b in zip(
            tree_leaves(trained), tree_leaves(init)))
        if not changed > 0:
            raise AssertionError("training left the params unchanged")
        t1 = time.time()
        metrics = test_fast_cli.main(test_fast_cli.parse_args(["-r",
                                                               str(best)]))
        serve_s = time.time() - t1
        bad = {k: v for k, v in metrics.items() if not np.isfinite(v)}
        if bad:
            raise AssertionError(f"non-finite metrics of the trained "
                                 f"checkpoint {bad}")
        if profile:
            extra, trainer = {}, trainers[0]
            traces = sorted(p.relative_to(run) for p in
                            (run / "profile").rglob("*") if p.is_file())
            if [str(p) for p in traces] != ["profile/trace.json"]:
                raise AssertionError(f"profiler traces {traces}")
            extra["profile"] = trace_split(run / "profile" / "trace.json")
            trainer.step_timing = False
            trainer.profile_dir = run / "profile_no_sync"
            with switches(env):
                trainer._train_epoch(1)     # epoch 1: the window again
            extra["profile_no_step_sync"] = trace_split(
                run / "profile_no_sync" / "trace.json")
            with switches(env):
                extra["runtime"] = trainer_runtime(trainer, run)
                extra["sync_repair"] = sync_repair(trainer, run)
            emit("profile", path=path, card=nvidia_smi_line(),
                 window=list(PROFILE_WINDOW),
                 epochs=epoch_split(
                     (config.log_dir / "info.log").read_text()), **extra)
            del trainer, trainers[:]
    step_ms = log.get("step_ms", [])
    egonets_per_step = (cfg["train_data_loader"]["args"]["batch_size"]
                        * (1 + cfg["train_data_loader"]["args"]
                           ["negative_size"]))
    median_ms = float(np.median(step_ms)) if step_ms else float("nan")
    with switches(env):
        step_vs_cpu = compare_train_step(device, cfg, taxonomy, trained,
                                         2 if model.aux_heads else 4,
                                         bf16=path in BF16_PATHS)
    res = {"path": path, "switches": env, "card": nvidia_smi_line(),
           "nodes": taxonomy.num_nodes,
           "dim": in_dim, "epochs": epochs,
           "steps_last_epoch": len(step_ms),
           "egonets_per_step": egonets_per_step,
           "step_ms_last_epoch": step_ms, "median_step_ms": median_ms,
           "egonets_per_s_median_step": egonets_per_step / median_ms * 1e3,
           "egonets_per_s_epoch": log["egonets_per_sec"],
           "loss_last_epoch": log["loss"],
           "val_metrics_last_epoch": {k[4:]: v for k, v in log.items()
                                      if k.startswith("val_")},
           "train_s": train_s,
           # the training run's peak device memory: its train steps' (the
           # validation encodes at most as many egonets a chunk, no grads)
           "max_memory_allocated_bytes": peak_bytes,
           "max_param_change": changed,
           "launches": launches, "served_metrics": metrics,
           "serve_s": serve_s, "step_vs_cpu": step_vs_cpu}
    emit("training", **res)
    return res


def _free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def run_ranks(run: Path, device, env: dict, extra: tuple = (),
              main: tuple = ("-m", "taxoexpan_torch.train")) -> list[dict]:
    """`python -m taxoexpan_torch.train -c run/config.json` as DP_RANKS
    rank processes (--coordinator / --num_processes / --process_id) on
    `device`'s type; returns each rank's report (report-rank<r>.json in the
    shared run directory). `extra`: more arguments of the CLI; `main`: what
    python runs in place of the CLI's module (a driver that calls its
    main). The ranks' output goes to run/rank<r>.log."""
    launch_ranks(run, env, list(main) + [
        "-c", str(run / "config.json"), "-d", device.type, *extra],
        "rank")
    runs = list((run / "saved" / "models").glob("*/*/"))
    if len(runs) != 1:
        raise AssertionError(f"expected one shared run directory, got "
                             f"{runs}")
    return [json.loads((runs[0] / f"report-rank{r}.json").read_text())
            | {"run_dir": str(runs[0])} for r in range(DP_RANKS)]


def launch_ranks(run: Path, env: dict, args: list, log: str) -> None:
    """`python <args> --coordinator ... --num_processes DP_RANKS
    --process_id r` for every rank r, their output in run/<log><r>.log. A
    rank that fails or outlives DP_TIMEOUT_S fails the phase; every rank
    is stopped before it returns."""
    coord = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ, PYTHONPATH=str(REPO), **env)
    cmd = [sys.executable, *args, "--coordinator", coord, "--num_processes",
           str(DP_RANKS)]
    logs = [open(run / f"{log}{r}.log", "w+") for r in range(DP_RANKS)]
    procs = [subprocess.Popen(cmd + ["--process_id", str(r)], cwd=REPO,
                              env=env, stdout=logs[r],
                              stderr=subprocess.STDOUT)
             for r in range(DP_RANKS)]
    try:
        # poll them all: a rank that fails early fails the phase at once,
        # with its own log, while its peer would wait in a collective
        deadline = time.time() + DP_TIMEOUT_S
        while any(proc.poll() is None for proc in procs):
            for r, proc in enumerate(procs):
                if proc.poll() not in (None, 0):
                    logs[r].seek(0)
                    raise AssertionError(f"rank {r} exited with "
                                         f"{proc.returncode}:\n"
                                         f"{logs[r].read()[-4000:]}")
            if time.time() > deadline:
                late = [r for r, proc in enumerate(procs)
                        if proc.poll() is None]
                raise AssertionError(f"ranks {late} did not finish in "
                                     f"{DP_TIMEOUT_S} s")
            time.sleep(0.2)
        for r, proc in enumerate(procs):
            if proc.returncode != 0:
                logs[r].seek(0)
                raise AssertionError(f"rank {r} exited with "
                                     f"{proc.returncode}:\n"
                                     f"{logs[r].read()[-4000:]}")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for f in logs:
            f.close()


def phase_dp_training(device, num_nodes: int, seed: int,
                      single_step_ms: float) -> dict:
    """The data-parallel path: `python -m taxoexpan_torch.train` as 2 rank
    processes on the card (two contexts sharing it, gloo between them) at
    config.mag.json's full width on the synthetic training taxonomy, 128
    groups x 32 candidates a step (64 groups a rank), one epoch with
    full-catalog validation (the ranker's data-parallel encode), twice:
    with the feature table replicated, and row-partitioned with
    TAXOEXPAN_HALO=ring (K6 reading the peer's shard through CUDA IPC).
    Both runs feed the kernels equal rows, so their epoch loss and final
    params must be equal bits: the check that the exchange moved the right
    rows. Rank 0's best checkpoint of the partitioned run serves through
    `taxoexpan_torch.test_fast`. The rank processes start with their launch
    counters at 0 and report them when training ends."""
    import numpy as np
    import torch
    from taxoexpan_torch import test_fast as test_fast_cli
    from taxoexpan_torch.data.synthetic import synthetic_taxonomy
    from taxoexpan_torch.training.checkpoint import load_checkpoint
    from taxoexpan_torch.tree import tree_leaves

    cfg, _model = path_model("PGAT")
    in_dim = cfg["arch"]["args"]["in_dim"]
    taxonomy = synthetic_taxonomy(num_nodes=num_nodes, dim=in_dim, seed=seed)
    torch.cuda.empty_cache()
    results = {}
    with tempfile.TemporaryDirectory() as tmp:
        data = Path(tmp) / "synthetic.pickle.bin"
        taxonomy.save(str(data))
        for mode, env in (("replicated", {}),
                          ("partitioned", {"TAXOEXPAN_HALO": DP_HALO})):
            run = Path(tmp) / mode
            run.mkdir()
            for loader in ("train_data_loader", "validation_data_loader",
                           "test_data_loader"):
                cfg[loader]["args"].update(data_path=str(data),
                                           **slot_args(cfg))
            cfg["trainer"].update(epochs=1, save_dir=str(run / "saved"),
                                  full_validation_every=1,
                                  tensorboardX=False, step_timing=True)
            cfg["parallel"] = {"dp": DP_RANKS, "feature_mode": mode}
            (run / "config.json").write_text(json.dumps(cfg))
            t0 = time.time()
            reports = run_ranks(run, device, env)
            wall_s = time.time() - t0
            ckpt = Path(reports[0]["run_dir"]) / "checkpoint-epoch1.ckpt"
            params = [np.asarray(a) for a in
                      tree_leaves(load_checkpoint(ckpt)["params"])]
            served = None
            if mode == "partitioned":
                best = Path(reports[0]["run_dir"]) / "model_best.ckpt"
                served = test_fast_cli.main(test_fast_cli.parse_args(
                    ["-r", str(best), "-d", device.type]))
                bad = {k: v for k, v in served.items()
                       if not np.isfinite(v)}
                if bad:
                    raise AssertionError(f"non-finite metrics of the 2-rank "
                                         f"checkpoint {bad}")
            results[mode] = {"reports": reports, "params": params,
                             "wall_s": wall_s, "served": served}

    rep, par = results["replicated"], results["partitioned"]
    losses = {m: [r["log"]["loss"] for r in results[m]["reports"]]
              for m in results}
    for m, ls in losses.items():
        if not np.isfinite(ls[0]) or len(set(ls)) != 1:
            raise AssertionError(f"{m}: the ranks' epoch losses {ls}")
    if losses["replicated"][0] != losses["partitioned"][0]:
        raise AssertionError(f"epoch loss: replicated {losses['replicated']}"
                             f", partitioned {losses['partitioned']}")
    unequal = sum(not np.array_equal(a, b)
                  for a, b in zip(rep["params"], par["params"]))
    if unequal:
        raise AssertionError(f"{unequal} param leaves differ between the "
                             "replicated and the partitioned run")
    launches = {m: [r["launches"] for r in results[m]["reports"]]
                for m in results}
    # (the rank processes of a CPU rehearsal run the plain versions and
    # count nothing)
    for m in results if device.type == "cuda" else ():
        for r, counts in enumerate(launches[m]):
            for name in ("gat_layer_fwd_train", "gat_layer_pooled_fwd_train",
                         "gat_layer_bwd", "gat_layer_pooled_bwd"):
                if counts[name] <= 0:
                    raise AssertionError(f"{m} rank {r} never launched "
                                         f"{name}")
    halo = [c["halo_gather"] for c in launches["partitioned"]]
    if device.type == "cuda" and DP_HALO == "ring" and min(halo) <= 0:
        raise AssertionError(f"the partitioned run's ranks launched K6 "
                             f"{halo} times")
    step_ms = {m: results[m]["reports"][0]["log"].get("step_ms", [])
               for m in results}
    median = {m: float(np.median(v)) if v else float("nan")
              for m, v in step_ms.items()}
    res = {"ranks": DP_RANKS, "halo": DP_HALO, "card": nvidia_smi_line(),
           "nodes": taxonomy.num_nodes, "dim": in_dim,
           "groups_per_step": cfg["train_data_loader"]["args"]["batch_size"],
           "loss": losses, "params_equal_bits": True,
           "param_leaves": len(rep["params"]),
           "step_ms_rank0": step_ms, "median_step_ms_2rank": median,
           "single_process_median_step_ms": single_step_ms,
           "note": "two rank processes sharing one card (two contexts "
                   "time-slicing it): not a scaling figure",
           "wall_s": {m: results[m]["wall_s"] for m in results},
           "launches_per_rank": launches,
           "val_macro_mr": {m: results[m]["reports"][0]["log"].get(
               "val_macro_mr") for m in results},
           "served_metrics": par["served"],
           # the kernels line's count: K6 over both ranks of the
           # partitioned run
           "launches": {"halo_gather": sum(halo)}}
    emit("dp_training", **res)
    return res


# a rank process of the tensor-parallel path: the entry point's main (through
# its own argument parser) and what the smoke reads back.
# `python -c RANK_DRIVER <what> <out dir> <the CLI's arguments>`:
# "train" traces the profiler window TP_WINDOW of epoch 1 into <out dir>
# (per rank: <out dir>/rank<r>-dp<d>-mp<m>/trace.json); "grads" writes every
# step's reduced grads (`recorded_grads`) as grads<r>.pkl; "test_fast" and
# "infer" write their files as case<r>.tsv / infer<r>.tsv, what their main
# returns (the metrics, the predictions) as <what><r>.json and the encoded
# anchors' graph embeddings as hg_<what><r>.pt into <out dir>.
TP_WINDOW = (1, 4)
RANK_DRIVER = """
import json, sys
from pathlib import Path
import torch
from taxoexpan_torch.parallel import distributed
what, out, argv = sys.argv[1], Path(sys.argv[2]), sys.argv[3:]
rank = int(argv[argv.index("--process_id") + 1])
try:
    if what == "train":
        from taxoexpan_torch import train as cli

        class Traced(cli.Trainer):
            def __init__(self, *args, **kwargs):
                super().__init__(*args, profile_dir=out, **kwargs)
                self._profile_window = WINDOW
        cli.Trainer = Traced
        cli.main(cli.parse_args(argv))
    elif what == "grads":
        import pickle
        from chip_smoke import recorded_grads
        from taxoexpan_torch import train as cli
        with recorded_grads(cli) as steps:
            cli.main(cli.parse_args(argv))
        (out / f"grads{rank}.pkl").write_bytes(pickle.dumps(steps))
    else:
        from taxoexpan_torch.evaluation.ranker import TaxonomyRanker
        encode = TaxonomyRanker.encode_all_anchors

        def keep(self):
            hg = encode(self)
            torch.save(hg.cpu(), out / f"hg_{what}{rank}.pt")
            return hg
        TaxonomyRanker.encode_all_anchors = keep
        if what == "test_fast":
            from taxoexpan_torch import test_fast as cli
            argv += ["-c", str(out / f"case{rank}.tsv")]
        else:
            from taxoexpan_torch import infer as cli
            argv += ["-s", str(out / f"infer{rank}.tsv")]
        result = cli.main(cli.parse_args(argv))
        (out / f"{what}{rank}.json").write_text(json.dumps(result,
                                                          default=int))
finally:
    distributed.shutdown()
""".replace("WINDOW", repr(TP_WINDOW))


@contextlib.contextmanager
def captured_hg():
    """The graph embeddings the rankers encode in this process (once a
    ranker and parameter set), in the list the block gets."""
    from taxoexpan_torch.evaluation.ranker import TaxonomyRanker
    encode, kept = TaxonomyRanker.encode_all_anchors, []

    def keep(self):
        fresh = self._hg is None
        hg = encode(self)
        if fresh:
            kept.append(hg.cpu())
        return hg
    TaxonomyRanker.encode_all_anchors = keep
    try:
        yield kept
    finally:
        TaxonomyRanker.encode_all_anchors = encode


# the TP-against-single-process epoch's param rule: SGD moves a param by lr
# times its grad, so the runs' final params part by lr times their grads'
# rounding differences (5.96e-08 at most on the card, 1 float32 ulp at 0.5)
TP_PARAM_ATOL = TP_PARAM_RTOL = 1e-6


@contextlib.contextmanager
def recorded_grads(train_cli):
    """The CLI's Trainer recording each step's grads as its train_step
    returns them (reduced over the ranks in a multi-process run), per step
    a list of the leaves as numpy arrays, into the list the block gets."""
    from taxoexpan_torch.tree import tree_leaves
    steps: list = []
    base = train_cli.Trainer

    class Recording(base):
        def train_step(self, batch, step_idx, return_grads=False):
            loss, grads = super().train_step(batch, step_idx,
                                             return_grads=True)
            steps.append([g.detach().cpu().numpy()
                          for g in tree_leaves(grads)])
            return (loss, grads) if return_grads else loss
    train_cli.Trainer = Recording
    try:
        yield steps
    finally:
        train_cli.Trainer = base


def collective_ms(path: Path) -> dict:
    """The host time of the process group's collectives in a profiler
    window's trace: the CPU events of gloo's collectives (their names
    start with "gloo:"), summed by name."""
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X" and "dur" in e
              and str(e.get("name", "")).startswith("gloo:")]
    out: dict = {}
    for e in events:
        calls, total = out.get(e["name"], (0, 0.0))
        out[e["name"]] = (calls + 1, total + e["dur"] / 1e3)
    return {name: {"calls": c, "ms": ms} for name, (c, ms) in out.items()}


def tp_against_single(device, cfg: dict, start: Path, tmp: Path,
                      layout: dict) -> dict:
    """One epoch at dropout 0 and with SGD in place of the config's
    optimizer, from the checkpoint `start`: the single process (`python -m
    taxoexpan_torch.train`'s main in this process), then DP_RANKS rank
    processes with "parallel" `layout`, each recording every step's reduced
    grads (`recorded_grads`; the ranks through `RANK_DRIVER`'s "grads"
    mode). SGD: AMSGrad's first steps are lr * sign(g) wherever |g| >>
    1e-8, so the rounding of a near-zero grad moves a param by up to 2 *
    lr, the next step's grads by more than rounding, and in 6 steps
    well-conditioned params by up to 0.8 * lr (seen on the card); an SGD
    step is linear in the grad and keeps rounding at its size. Checks: the
    ranks' epoch losses equal and within 1e-4 of the single process's,
    their grads equal bits at every step, and rank 0's within
    `grads_vs_reference`'s rule of the single process's. Returns both
    runs' logs, final params (numpy leaves) and grads, the ranks' reports,
    the per-step worst differences and the ranks' wall seconds."""
    import copy

    import numpy as np
    from taxoexpan_torch import train as train_cli
    from taxoexpan_torch.training.checkpoint import load_checkpoint
    from taxoexpan_torch.tree import tree_leaves
    runs = {}
    for name, parallel in (("single", None), ("tp", layout)):
        run = tmp / name
        run.mkdir()
        c = copy.deepcopy(cfg)
        c["arch"]["args"].update(feat_drop=0.0, attn_drop=0.0)
        c["optimizer"] = {"type": "SGD", "args": {
            "lr": cfg["optimizer"]["args"]["lr"]}}
        c["trainer"]["save_dir"] = str(run / "saved")
        if parallel:
            c["parallel"] = parallel
        (run / "config.json").write_text(json.dumps(c))
        runs[name] = run
    config = train_cli.parse_args(["-c", str(runs["single"] / "config.json"),
                                   "-r", str(start), "-d", device.type])
    with recorded_grads(train_cli) as single_grads:
        single_log = train_cli.main(config)
    single_params = [np.asarray(a) for a in tree_leaves(load_checkpoint(
        config.save_dir / "checkpoint-epoch1.ckpt")["params"])]
    t0 = time.time()
    tp = run_ranks(runs["tp"], device, {}, extra=("-r", str(start)),
                   main=("-c", RANK_DRIVER, "grads", str(runs["tp"])))
    wall_s = time.time() - t0
    tp_params = [np.asarray(a) for a in tree_leaves(load_checkpoint(
        Path(tp[0]["run_dir"]) / "checkpoint-epoch1.ckpt")["params"])]
    losses = [r["log"]["loss"] for r in tp]
    if len(set(losses)) != 1 or abs(losses[0] - single_log["loss"]) > \
            1e-4 * abs(single_log["loss"]):
        raise AssertionError(f"epoch loss: ranks {losses}, single "
                             f"process {single_log['loss']}")
    tp_grads = [pickle.loads((runs["tp"] / f"grads{r}.pkl").read_bytes())
                for r in range(DP_RANKS)]
    if not len(tp_grads[0]) == len(single_grads) > 0:
        raise AssertionError(f"steps: TP {len(tp_grads[0])}, single "
                             f"process {len(single_grads)}")
    for other in tp_grads[1:]:
        for step, (a, b) in enumerate(zip(tp_grads[0], other)):
            if not all(np.array_equal(x, y) for x, y in zip(a, b)):
                raise AssertionError(f"step {step}: the ranks' reduced "
                                     "grads differ")
    worst = [grads_vs_reference(got, want, 1e-3, f"TP step {step}")
             for step, (got, want) in enumerate(zip(tp_grads[0],
                                                    single_grads))]
    return {"single_log": single_log, "single_params": single_params,
            "single_grads": single_grads, "tp": tp, "tp_params": tp_params,
            "tp_grads": tp_grads[0], "losses": losses,
            "max_grad_err_rel_to_leaf_max": worst, "wall_s": wall_s}


def phase_tp_training(device, num_nodes: int, seed: int,
                      single_step_ms: float) -> dict:
    """The tensor-parallel path: `python -m taxoexpan_torch.train` as 2
    rank processes sharing the card (gloo, --coordinator) with
    config.mag.json and "parallel": {"dp": 1, "mp": 2} at full width on the
    synthetic training taxonomy (128 groups x 32 candidates a step, the
    whole batch on both ranks; layer 0's 4 heads split 2 a rank through
    K1t / K2 at the shard, the 1-head final layer whole on both through
    K3t / K4; full-catalog validation with the heads split), one epoch
    from a start checkpoint (the seeded init), twice:
    - at dropout 0 and with SGD in place of AMSGrad (see below), against
      the single-process run (`python -m taxoexpan_torch.train`'s main in
      this process) from the same checkpoint: the epoch loss to 1e-4,
      every step's reduced grads equal bit for bit on both ranks and
      within `grads_vs_reference`'s rule of the single process's, every
      element of the final params within TP_PARAM_ATOL + TP_PARAM_RTOL of
      the single process's;
    - at the config's dropout, its profiler window traced on both ranks
      (TP_WINDOW): a finite loss, changed params, both ranks' final params
      equal bit for bit (their digests), the launches of K1t and K2 at the
      shard's heads and of K3t and K4 at the final layer's whole heads on
      every rank.
    Then `python -m taxoexpan_torch.test_fast -m` and `infer -m` as 2 rank
    processes (the anchors' encoding split between them) on rank 0's
    checkpoint of the second run against the single process: equal
    metrics, case study and predictions (written by rank 0 alone), graph
    embeddings within 1e-5 of their largest value. The TP median step
    stands beside the single-process step (two contexts time-slicing one
    card: not a scaling figure), with the collectives' host time from the
    traces."""
    import copy

    import numpy as np
    import torch
    from taxoexpan_torch import builders
    from taxoexpan_torch import infer as infer_cli
    from taxoexpan_torch import test_fast as test_fast_cli
    from taxoexpan_torch.data.synthetic import synthetic_taxonomy
    from taxoexpan_torch.training.checkpoint import (load_checkpoint,
                                                     save_checkpoint)
    from taxoexpan_torch.tree import tree_leaves

    cfg, model = path_model("PGAT")
    in_dim = cfg["arch"]["args"]["in_dim"]
    taxonomy = synthetic_taxonomy(num_nodes=num_nodes, dim=in_dim, seed=seed)
    rng = np.random.default_rng(seed)
    held = np.asarray(taxonomy.test_node_ids[:N_NOVEL], dtype=np.int64)
    novel = taxonomy.features[held] + 0.1 * rng.normal(
        size=(len(held), in_dim)).astype(np.float32)
    torch.cuda.empty_cache()
    res = {"ranks": DP_RANKS, "layout": {"dp": 1, "mp": DP_RANKS},
           "card": nvidia_smi_line(), "nodes": taxonomy.num_nodes,
           "dim": in_dim,
           "groups_per_step": cfg["train_data_loader"]["args"]["batch_size"],
           "single_process_median_step_ms": single_step_ms,
           "note": "two rank processes sharing one card (two contexts "
                   "time-slicing it), the layer-0 gather staged through "
                   "the host (gloo): not a scaling figure"}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        data = tmp / "synthetic.pickle.bin"
        taxonomy.save(str(data))
        for loader in ("train_data_loader", "validation_data_loader",
                       "test_data_loader"):
            cfg[loader]["args"].update(data_path=str(data),
                                       **slot_args(cfg))
        cfg["trainer"].update(epochs=1, full_validation_every=1,
                              tensorboardX=False, step_timing=True)
        params = model.init(torch.Generator().manual_seed(cfg.get("seed",
                                                                  0)))
        opt = builders.build_optimizer_from_config(cfg["optimizer"],
                                                   cfg["trainer"])
        start = tmp / "start" / "epoch0.ckpt"
        start.parent.mkdir()
        save_checkpoint(start, params=params, opt_state=opt.init(params),
                        epoch=0, monitor_best=float("inf"), config=cfg)
        init = [np.asarray(a) for a in tree_leaves(
            load_checkpoint(start)["params"])]

        layout = {"dp": 1, "mp": DP_RANKS}
        local = cfg["arch"]["args"]["heads"][0] // DP_RANKS
        # ---- dropout 0 and SGD: the single process, then the two ranks
        against = tp_against_single(device, cfg, start, tmp, layout)
        single_log, tp = against["single_log"], against["tp"]
        losses = against["losses"]
        wall = {"tp_dropout0": against["wall_s"]}
        vs_single = {"max_grad_err_rel_to_leaf_max":
                     against["max_grad_err_rel_to_leaf_max"]}
        worst = 0.0
        for i, (got, want) in enumerate(zip(against["tp_params"],
                                            against["single_params"])):
            err = np.abs(got - want)
            if (err > TP_PARAM_ATOL + TP_PARAM_RTOL * np.abs(want)).any():
                raise AssertionError(f"final params: leaf {i} "
                                     f"{want.shape} differs by "
                                     f"{float(err.max())}")
            worst = max(worst, float(err.max()))
        del against
        vs_single.update(
            max_param_err=worst, loss_rel_diff=abs(
                losses[0] - single_log["loss"]) / abs(single_log["loss"]),
            rule=f"grads: 1e-3 x leaf max + 1e-6 x step max, every step; "
                 f"params: {TP_PARAM_ATOL} + {TP_PARAM_RTOL} x |param|, "
                 "every element")

        # ---- the config's dropout, traced
        run = tmp / "tp_dropout"
        run.mkdir()
        c = copy.deepcopy(cfg)
        c["trainer"]["save_dir"] = str(run / "saved")
        c["parallel"] = layout
        (run / "config.json").write_text(json.dumps(c))
        t0 = time.time()
        tpd = run_ranks(run, device, {}, extra=("-r", str(start)),
                        main=("-c", RANK_DRIVER, "train",
                              str(run / "profile")))
        wall["tp_dropout"] = time.time() - t0
        ckpt = Path(tpd[0]["run_dir"]) / "checkpoint-epoch1.ckpt"
        trained = [np.asarray(a) for a in tree_leaves(
            load_checkpoint(ckpt)["params"])]
        if not np.isfinite(tpd[0]["log"]["loss"]):
            raise AssertionError(f"non-finite TP loss {tpd[0]['log']}")
        changed = max(float(np.abs(a - b).max())
                      for a, b in zip(trained, init))
        if not changed > 0:
            raise AssertionError("TP training left the params unchanged")
        digests = [r["params_sha256"] for r in tpd]
        if len(set(digests)) != 1:
            raise AssertionError(f"the ranks' final params differ: "
                                 f"{digests}")
        if [(r["dp_index"], r["mp_index"]) for r in tpd] != [(0, 0),
                                                             (0, 1)]:
            raise AssertionError(f"rank layout {tpd}")
        traces = {}
        for r in tpd:
            trace = (run / "profile" / f"rank{r['rank']}-dp{r['dp_index']}"
                     f"-mp{r['mp_index']}" / "trace.json")
            traces[r["rank"]] = {**trace_split(trace),
                                 "collectives_host": collective_ms(trace)}
        # at dropout 0 the layers' forwards are the eval kernels; with
        # dropout the train forms (the rank processes of a CPU rehearsal run
        # the plain versions and count nothing): layer 0's at the shard's
        # heads, the final layer's at its whole heads
        whole = str(cfg["arch"]["args"]["heads"][-1])
        for reports, forwards in (
                (tp, ("gat_layer_fwd", "gat_layer_pooled_fwd")),
                (tpd, ("gat_layer_fwd_train", "gat_layer_pooled_fwd_train"))):
            for r in reports if device.type == "cuda" else ():
                for name in forwards + ("gat_layer_bwd",
                                        "gat_layer_pooled_bwd"):
                    key = whole if "pooled" in name else str(local)
                    if r["launches_by_heads"][name].get(key, 0) <= 0:
                        raise AssertionError(f"TP rank {r['rank']} never "
                                             f"launched {name} at {key} "
                                             "heads")

        # ---- test_fast -m and infer -m on 2 ranks against one process
        ev = tmp / "eval"
        ev.mkdir()
        (ev / "novel.txt").write_text("".join(
            f"novel term {i}\t{' '.join(map(str, row))}\n"
            for i, row in enumerate(novel)))
        cli = ["-r", str(ckpt), "-d", device.type, "-m"]
        t0 = time.time()
        launch_ranks(ev, {}, ["-c", RANK_DRIVER, "test_fast", str(ev), *cli],
                     "test_fast")
        launch_ranks(ev, {}, ["-c", RANK_DRIVER, "infer", str(ev), *cli,
                              "-t", str(ev / "novel.txt")], "infer")
        wall["eval_2rank"] = time.time() - t0
        with captured_hg() as hg:
            single_metrics = test_fast_cli.main(test_fast_cli.parse_args(
                ["-r", str(ckpt), "-d", device.type, "-c",
                 str(ev / "case_single.tsv")]))
            single_preds = infer_cli.main(infer_cli.parse_args(
                ["-r", str(ckpt), "-d", device.type, "-t",
                 str(ev / "novel.txt"), "-s", str(ev / "infer_single.tsv")]))
        for what, want in (("test_fast", single_metrics),
                           ("infer", single_preds)):
            got = [json.loads((ev / f"{what}{r}.json").read_text())
                   for r in range(DP_RANKS)]
            if any(g != json.loads(json.dumps(want, default=int))
                   for g in got):
                raise AssertionError(f"{what} -m returned {got}, the single "
                                     f"process {want}")
        for name in ("case", "infer"):
            if (ev / f"{name}0.tsv").read_text() != \
                    (ev / f"{name}_single.tsv").read_text():
                raise AssertionError(f"the 2-rank {name} file differs")
            if (ev / f"{name}1.tsv").exists():
                raise AssertionError(f"rank 1 wrote its {name} file")
        hg_err = {}
        for what, ref in zip(("test_fast", "infer"), hg):
            for r in range(DP_RANKS):
                got = torch.load(ev / f"hg_{what}{r}.pt")
                err = float((got - ref).abs().max()) / max(
                    float(ref.abs().max()), 1e-30)
                if got.shape != ref.shape or err > 1e-5:
                    raise AssertionError(f"{what} -m: rank {r}'s graph "
                                         f"embeddings differ by {err} of "
                                         "their largest value")
                hg_err[f"{what} rank{r}"] = err

    def median(r):
        return float(np.median(r["log"]["step_ms"])) \
            if r["log"].get("step_ms") else float("nan")
    by_heads: dict = {}
    for r in tp + tpd:
        for name, counts in r["launches_by_heads"].items():
            mine = by_heads.setdefault(name, {})
            for k, v in counts.items():
                mine[k] = mine.get(k, 0) + v
    res.update({
        "loss": {"tp_dropout0": losses, "single_dropout0": single_log["loss"],
                 "tp_dropout": [r["log"]["loss"] for r in tpd]},
        "vs_single_process": vs_single, "params_equal_bits_dropout": True,
        "max_param_change_dropout": changed,
        "median_step_ms": {"tp_dropout0": [median(r) for r in tp],
                           "tp_dropout": [median(r) for r in tpd]},
        "step_ms_rank0": {"tp_dropout0": tp[0]["log"].get("step_ms"),
                          "tp_dropout": tpd[0]["log"].get("step_ms")},
        "profile": {"window": list(TP_WINDOW), "ranks": traces},
        "launches_per_rank": {"tp_dropout0": [r["launches"] for r in tp],
                              "tp_dropout": [r["launches"] for r in tpd]},
        "val_macro_mr": [r["log"].get("val_macro_mr") for r in tpd],
        "eval_2rank": {"metrics": single_metrics,
                       "hg_err_rel_to_max": hg_err},
        "wall_s": wall,
        # both runs, both ranks, by heads on the rank (the kernels line's
        # TP rows read those at `heads_local`)
        "launches_by_heads": by_heads, "heads_local": local})
    emit("tp_training", **res)
    return res


@contextlib.contextmanager
def plain_on_card():
    """The star-GAT and star-GCN wrappers run their plain versions on CUDA
    tensors for the block: the plain path on the card, for the residual
    check's reference (no path of the port runs this way)."""
    from taxoexpan_torch.ops import gat_kernels as gk
    from taxoexpan_torch.ops import gcn_kernels as ck
    saved = gk.on_cuda, ck.on_cuda
    gk.on_cuda = ck.on_cuda = lambda x, what: False
    try:
        yield
    finally:
        gk.on_cuda, ck.on_cuda = saved


# the residual check: egonets of the train step held against the plain path
RESIDUAL_GROUPS = 32


def residual_model(device):
    """config.mag.json's PGAT-concat with its propagation replaced by
    `GAT(residual=True)` at the same widths (layer 0: 300 -> 4 x 500; the
    final layer residual, 2050 -> 1 x 500 plus x @ res_fc [2050, 500]), and
    its params from seed SEED on `device`."""
    import torch
    from taxoexpan_torch.models.propagation import GAT
    from taxoexpan_torch.weights import params_to
    cfg, model = path_model("PGAT-concat")
    a = cfg["arch"]["args"]
    model.propagate = GAT(a["in_dim"], a["hidden_dim"], a["out_dim"],
                          a["num_layers"], a["heads"], pos_dim=a["pos_dim"],
                          feat_drop=a["feat_drop"], attn_drop=a["attn_drop"],
                          pos_mode="concat", residual=True)
    return cfg, model, params_to(model.init(
        torch.Generator().manual_seed(SEED)), device)


def phase_residual(device) -> dict:
    """Residual GAT layers on the card (`residual_model`): the eval encode
    of BATCH random egonets (the final layer per slot, as a residual final
    layer has no pooled form, then the WMR readout) and one train step
    (RESIDUAL_GROUPS groups of the synthetic training taxonomy at the
    config's dropout: the residual layer's input mask drawn once outside
    the kernel, K1t with the attention dropout inside) through the kernels,
    each against the same call on the plain path on the card
    (`plain_on_card`): hg to RTOL / ATOL, the loss to 1e-4 relative, each
    grad by `grads_vs_reference`'s rule (1e-3 of its leaf's largest value).
    The launches of the kernel runs: the per-slot forms only (K1 eval, K1t,
    K2), none of the pooled ones."""
    import torch
    from taxoexpan_torch import builders
    from taxoexpan_torch.data.synthetic import synthetic_taxonomy
    from taxoexpan_torch.ops import gat_kernels as gk
    from taxoexpan_torch.training.trainer import Trainer, batch_to
    from taxoexpan_torch.tree import tree_leaves
    cfg, model, params = residual_model(device)
    a = cfg["arch"]["args"]
    gen = torch.Generator().manual_seed(SEED)
    feats, ngp, nsib = random_egonets(gen, BATCH, a["in_dim"], device,
                                      model.expand_factor)

    def counts():
        return {name: w.launches for name, w in gk.WRAPPERS.items()
                if w.launches}
    reset_counters()
    t0 = time.time()
    with torch.no_grad():
        hg = model.encode(params, feats, ngp, nsib)
        torch.cuda.synchronize()
    encode_s = time.time() - t0
    eval_launches = counts()
    with plain_on_card(), torch.no_grad():
        hg_plain = model.encode(params, feats, ngp, nsib)
    encode_check = compare("residual encode (kernels vs the plain path on "
                           "the card)", hg, hg_plain)
    del feats, hg, hg_plain
    torch.cuda.empty_cache()

    taxonomy = synthetic_taxonomy(num_nodes=TRAIN_NODES, dim=a["in_dim"],
                                  seed=SEED)
    train_cfg = dict(cfg["train_data_loader"]["args"],
                     batch_size=RESIDUAL_GROUPS, num_workers=0,
                     **slot_args(cfg))
    sampler = builders.build_sampler(taxonomy, train_cfg, "train")
    batch = batch_to(next(iter(builders.build_loader(sampler, train_cfg))),
                     device)
    steps = {}
    with tempfile.TemporaryDirectory() as tmp:
        for label, form in (("kernels", contextlib.nullcontext),
                            ("plain", plain_on_card)):
            opt = builders.build_optimizer_from_config(cfg["optimizer"],
                                                       cfg["trainer"])
            tr = Trainer(model, params, opt, opt.init(params),
                         loss_name=cfg["loss"], metric_names=cfg["metrics"],
                         feature_table=sampler.node_features,
                         train_loader=None, save_dir=tmp, device=device)
            reset_counters()
            with form():
                loss, grads = tr.train_step(batch, 12345, return_grads=True)
                torch.cuda.synchronize()
            steps[label] = (float(loss), [g.cpu().numpy()
                                          for g in tree_leaves(grads)],
                            counts())
            del tr, grads
    (l_k, g_k, train_launches), (l_p, g_p, _) = steps["kernels"], \
        steps["plain"]
    if not abs(l_k - l_p) <= 1e-4 * abs(l_p):
        raise AssertionError(f"residual train step loss: kernels {l_k}, "
                             f"plain path {l_p}")
    worst = grads_vs_reference(g_k, g_p, 1e-3, "residual train step")
    for what, got, need in (
            ("eval", eval_launches, ("gat_layer_fwd",)),
            ("train", train_launches, ("gat_layer_fwd_train",
                                       "gat_layer_bwd"))):
        pooled = {k: v for k, v in got.items() if "pooled" in k}
        if pooled or any(got.get(k, 0) < 2 for k in need):
            raise AssertionError(f"residual {what} launches {got}: expected "
                                 f"{need} twice (both layers per slot) and "
                                 "no pooled form")
    res = {"card": nvidia_smi_line(), "model": "config.mag.json PGAT, "
           "pos_mode concat, GAT(residual=True)",
           "layers": [list(spec) + [r] for spec, r in zip(
               model.propagate.layer_specs, model.propagate.residual_layers)],
           "encode_egonets": BATCH, "encode_s": encode_s,
           "hg_vs_plain": encode_check, "eval_launches": eval_launches,
           "train_egonets": int(batch.labels.numel()), "loss": l_k,
           "loss_plain": l_p,
           "max_grad_err_rel_to_leaf_max": worst,
           "train_launches": train_launches}
    emit("residual", **res)
    torch.cuda.empty_cache()
    return res


# the mp = 2 step of PGAT-concat: a taxonomy whose epoch is two steps of
# config.mag.json's 128 groups
TP_CONCAT_NODES = 150


def phase_tp_concat(device, seed: int) -> dict:
    """One epoch (TP_CONCAT_NODES nodes: two steps) of PGAT-concat
    (config.mag.json with pos_mode "concat", full width) as 2 rank
    processes sharing the card with "parallel": {"dp": 1, "mp": 2} (layer
    0's 4 heads split 2 a rank, its input grad on; the pe columns' grads of
    the sharded layer summed with its pos_emb leaf over the world) against
    the single process from the same checkpoint (`tp_against_single`); the
    pos_emb and layer-0 leaves' largest differences reported apart, and
    the step times."""
    import numpy as np
    import torch
    from taxoexpan_torch import builders
    from taxoexpan_torch.data.synthetic import synthetic_taxonomy
    from taxoexpan_torch.training.checkpoint import save_checkpoint
    from taxoexpan_torch.tree import tree_leaves_with_path

    cfg, model = path_model("PGAT-concat")
    a = cfg["arch"]["args"]
    taxonomy = synthetic_taxonomy(num_nodes=TP_CONCAT_NODES,
                                  dim=a["in_dim"], seed=seed)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        data = tmp / "synthetic.pickle.bin"
        taxonomy.save(str(data))
        for loader in ("train_data_loader", "validation_data_loader",
                       "test_data_loader"):
            cfg[loader]["args"].update(data_path=str(data),
                                       **slot_args(cfg))
        cfg["trainer"].update(epochs=1, full_validation_every=1,
                              tensorboardX=False, step_timing=True)
        params = model.init(torch.Generator().manual_seed(cfg.get("seed",
                                                                  0)))
        opt = builders.build_optimizer_from_config(cfg["optimizer"],
                                                   cfg["trainer"])
        start = tmp / "epoch0.ckpt"
        save_checkpoint(start, params=params, opt_state=opt.init(params),
                        epoch=0, monitor_best=float("inf"), config=cfg)
        against = tp_against_single(device, cfg, start, tmp,
                                    {"dp": 1, "mp": DP_RANKS})
    tp = against["tp"]
    paths = [p for p, _ in tree_leaves_with_path(params)]
    picked = {"pos_emb": [i for i, p in enumerate(paths)
                          if p[:2] == ("propagate", "pos_emb")],
              "layer0": [i for i, p in enumerate(paths)
                         if p[:3] == ("propagate", "layers", 0)]}
    parts = {k: 0.0 for k in picked}
    for got, want in zip(against["tp_grads"], against["single_grads"]):
        for key, idx in picked.items():
            for i in idx:
                scale = max(float(np.abs(want[i]).max()), 1e-30)
                parts[key] = max(parts[key], float(
                    np.abs(got[i] - want[i]).max()) / scale)
    local = a["heads"][0] // DP_RANKS
    for r in tp if device.type == "cuda" else ():
        for name in ("gat_layer_fwd", "gat_layer_bwd"):
            if r["launches_by_heads"][name].get(str(local), 0) <= 0:
                raise AssertionError(f"TP concat rank {r['rank']} never "
                                     f"launched {name} at {local} heads")
    res = {"card": nvidia_smi_line(), "layout": {"dp": 1, "mp": DP_RANKS},
           "nodes": taxonomy.num_nodes,
           "steps": len(against["single_grads"]),
           "loss": {"tp": against["losses"],
                    "single": against["single_log"]["loss"]},
           "max_grad_err_rel_to_leaf_max":
               against["max_grad_err_rel_to_leaf_max"],
           "max_err_rel_to_leaf_max": parts,
           "rule": "1e-3 x leaf max + 1e-6 x step max, every leaf and step",
           "ranks_equal_bits": True, "wall_s": against["wall_s"],
           "step_ms": {"tp_rank0": tp[0]["log"].get("step_ms"),
                       "single": against["single_log"].get("step_ms")},
           "launches_by_heads_rank0": tp[0]["launches_by_heads"]}
    emit("tp_concat", **res)
    return res


# the native_loader phase: the synthetic v2 benchmark of
# artifacts/DIFFICULTY_CURVE.md at its settings, trained at config.mag.json's
# full width for two epochs with sampled validation, once a backend
NATIVE_DATA = ("--v2", "--nodes", "30000", "--dim", "250", "--max_children",
               "40", "--seed", "42", "--noise", "1.0")
NATIVE_EPOCHS = 2
NATIVE_BACKENDS = ("native", "python")


@contextlib.contextmanager
def recorded_batches(log: list):
    """Every batch a GroupBatchLoader builds in the block (either backend),
    as (its sampler, its queries, the batch), on the loaders' threads."""
    from taxoexpan_torch.data.loader import GroupBatchLoader
    build = GroupBatchLoader._build_batch

    def recording(self, queries):
        batch = build(self, queries)
        log.append((self.sampler, list(queries), batch))
        return batch

    GroupBatchLoader._build_batch = recording
    try:
        yield
    finally:
        GroupBatchLoader._build_batch = build


def native_invariants(records: list) -> dict:
    """tests/test_native_sampler.py's invariants on every recorded batch
    (:24-53 for the train layout, :117-155 for the validation layout), and
    the slot layout: ids in range, ngp <= max_parents, nsib <=
    expand_factor, the slots past them and the padded groups empty; a
    train group's positive (a true parent) in column 0 and its negatives
    train positions outside the query's masks (where the unmasked pool is
    large enough that the sampler's 10-try refill cannot have given up,
    :44-47); a validation group's positives (every true parent, in order)
    leading, then at least one negative, contiguous, unmasked; no positive
    egonet lists its query among the siblings. Returns the batches and
    groups checked by mode."""
    import numpy as np
    checked = {}
    for s, queries, b in records:
        p, k = s.max_parents, s.expand_factor
        ids, ngp, nsib = b.ego.node_ids, b.ego.ngp, b.ego.nsib
        g, c = len(queries), b.labels.shape[1]
        where = f"{s.mode} batch of queries {queries[:3]}..."
        if ids.shape != (b.labels.shape[0] * c, p + 1 + k):
            raise AssertionError(f"{where}: node_ids {ids.shape}")
        if ids.min() < 0 or ids.max() >= s.taxonomy.num_nodes:
            raise AssertionError(f"{where}: ids out of range")
        if (ngp < 0).any() or (ngp > p).any() or (nsib < 0).any() \
                or (nsib > k).any():
            raise AssertionError(f"{where}: ngp / nsib out of range")
        if ids[:, :p][np.arange(p)[None] >= ngp[:, None]].any() or \
                ids[:, p + 1:][np.arange(k)[None] >= nsib[:, None]].any():
            raise AssertionError(f"{where}: a slot past ngp / nsib is set")
        if b.cand_mask[g:].any() or b.labels[g:].any():
            raise AssertionError(f"{where}: a padded group holds "
                                 "candidates")
        anchors = ids[:, p].reshape(-1, c)[:g].tolist()
        labels, mask = b.labels[:g], b.cand_mask[:g]
        if s.sampling_mode == 1 and not (
                mask.all() and (labels[:, 0] == 1).all()
                and (labels[:, 1:] == 0).all()):
            raise AssertionError(f"{where}: train labels / cand_mask")
        mp = s.max_query_parents
        for gi, q in enumerate(queries):
            row, masks = anchors[gi], s.node2masks[q]
            parents = s.node2parents[q]
            if s.sampling_mode == 1:
                npos, negs = 1, row[1:]
                if row[0] not in parents:
                    raise AssertionError(f"{where}: query {q}'s positive "
                                         f"{row[0]} is not a parent")
                check_masks = len(s.all_positions) - len(masks) >= \
                    10 * s.negative_size
            else:
                npos = len(parents)
                negs_at = np.flatnonzero(mask[gi, mp:])
                if not ((labels[gi, :npos] == 1).all()
                        and (labels[gi, npos:] == 0).all()
                        and mask[gi, :npos].all()
                        and not mask[gi, npos:mp].any()
                        and row[:npos] == parents and len(negs_at)
                        and (negs_at == np.arange(len(negs_at))).all()):
                    raise AssertionError(f"{where}: query {q}'s group "
                                         "layout")
                negs, check_masks = row[mp:mp + len(negs_at)], True
            for j in range(npos):
                r = gi * c + j
                if (ids[r, p + 1:p + 1 + nsib[r]] == q).any():
                    raise AssertionError(f"{where}: query {q} among its "
                                         "positive's siblings")
            for a in negs:
                if a not in s.all_positions or (check_masks and a in masks):
                    raise AssertionError(f"{where}: query {q}'s negative "
                                         f"{a} is masked or no position")
        n = checked.setdefault(s.mode, {"batches": 0, "groups": 0})
        n["batches"] += 1
        n["groups"] += g
    return checked


def layouts_equal(native: list, python: list) -> dict:
    """The native and Python runs' batches where both are deterministic,
    batch for batch in the loaders' (equally seeded) order: the queries,
    labels and cand_mask of every group (a validation group's positive
    columns), the positive anchors and their grandparent slots."""
    import numpy as np
    compared = {}
    for mode in ("train", "validation"):
        nat = [r for r in native if r[0].mode == mode]
        py = [r for r in python if r[0].mode == mode]
        if len(nat) != len(py):
            raise AssertionError(f"{mode}: {len(nat)} native batches, "
                                 f"{len(py)} Python ones")
        for (s, qn, bn), (_s, qp, bp) in zip(nat, py):
            c = bn.labels.shape[1]
            mp = 1 if s.sampling_mode == 1 else s.max_query_parents
            cols = slice(None) if s.sampling_mode == 1 else slice(0, mp)
            pos = bn.cand_mask[:, :mp]
            rows = (np.arange(bn.labels.shape[0])[:, None] * c
                    + np.arange(mp)[None])[pos]
            head = slice(0, s.max_parents + 1)   # grandparents, anchor
            same = (qn == qp
                    and np.array_equal(bn.labels, bp.labels)
                    and np.array_equal(bn.cand_mask[:, cols],
                                       bp.cand_mask[:, cols])
                    and np.array_equal(bn.ego.ngp[rows], bp.ego.ngp[rows])
                    and np.array_equal(bn.ego.node_ids[rows, head],
                                       bp.ego.node_ids[rows, head]))
            if not same:
                raise AssertionError(f"{mode}: the native and Python "
                                     f"layouts differ (queries {qn[:3]}...)")
        compared[mode] = len(nat)
    return compared


def simple_mlp_card(data: Path, device) -> dict:
    """The simple_mlp baseline (DeepAPGMLP: every layer of the family) on
    the card against its CPU run on `data`, from the same seeded init at
    dropout 0: the eval-mode scores of 3 test queries against 4096
    candidates and one 64-edge batch's loss within 1e-5, every grad within
    1e-5 of its leaf's largest value (float32 GEMMs in another order);
    then `python -m taxoexpan_torch.baselines.simple_mlp` (its main, one
    epoch with dropout, on the card) to finite metrics."""
    import numpy as np
    import torch
    from taxoexpan_torch.baselines import simple_mlp
    from taxoexpan_torch.data.taxonomy import Taxonomy
    from taxoexpan_torch.tree import tree_leaves
    taxo = Taxonomy.load(str(data))
    runs = [simple_mlp.SimpleMLPBaseline(taxo, model="DeepAPGMLP", device=d)
            for d in ("cpu", device)]
    cand = np.asarray(taxo.train_node_ids[:4096], np.int32)
    sets = [runs[0]._sets_for(int(a), -1) for a in cand]
    sibs = np.asarray([s for s, _ in sets], np.int32)
    gps = np.asarray([g for _, g in sets], np.int32)
    err = {"scores": 0.0, "grads_rel": 0.0}
    for q in taxo.test_node_ids[:3]:
        cpu, card = (b.scores(cand, sibs, gps, int(q)) for b in runs)
        err["scores"] = max(err["scores"], float(np.abs(card - cpu).max()))
        if not np.allclose(card, cpu, rtol=1e-5, atol=1e-5):
            raise AssertionError(f"simple_mlp scores of query {q}: card "
                                 f"vs CPU {np.abs(card - cpu).max()}")
    batch = runs[0]._sample_batch(runs[0].train_edges[:64])
    losses, grads = [], []
    for b in runs:
        b.model.drop = 0.0
        loss = b.loss(*batch)
        loss.backward()
        losses.append(float(loss.detach()))
        grads.append([p.grad.cpu() for p in
                      tree_leaves(b.model.param_tree())])
    err["loss"] = abs(losses[1] - losses[0])
    if err["loss"] > 1e-5 * abs(losses[0]):
        raise AssertionError(f"simple_mlp loss: card {losses[1]} vs CPU "
                             f"{losses[0]}")
    for got, want in zip(grads[1], grads[0]):
        rel = float((got - want).abs().max() / want.abs().max())
        err["grads_rel"] = max(err["grads_rel"], rel)
        if rel > 1e-5:
            raise AssertionError(f"simple_mlp grads: card vs CPU {rel} of "
                                 "the leaf's largest")
    del runs, grads
    t0 = time.time()
    metrics = simple_mlp.main(["--data", str(data), "--model", "DeepAPGMLP",
                               "--epochs", "1", "-d", device.type])
    torch.cuda.synchronize()
    bad = {k: v for k, v in metrics.items()
           if isinstance(v, float) and not np.isfinite(v)}
    if bad:
        raise AssertionError(f"simple_mlp metrics not finite: {bad}")
    res = {"model": "DeepAPGMLP", "vs_cpu": err, "card_run_s":
           time.time() - t0, "metrics": metrics}
    emit("simple_mlp", card=nvidia_smi_line(), **res)
    return res


def phase_native_loader(device) -> dict:
    """The host data path: `python -m taxoexpan_torch.train` (its main, in
    this process) at config.mag.json's full width on a dataset the port
    makes itself (`tools.make_synthetic_dataset --v2`, 30000 nodes, dim
    250, the settings of artifacts/DIFFICULTY_CURVE.md), 128 groups x 32
    candidates = 4096 egonets a step, two epochs with sampled validation
    (128 groups x 257 candidates a batch), once with loader backend
    "native" (the C++ sampler, built by phase_build) and once "python",
    same seed, the trainer's profiler window on (batches 10-15 of epoch
    1), the launch counters set to 0 just before each run and read just
    after. Checks: each epoch's log names the backend it ran; a finite
    loss that falls from epoch 1 to 2; K1t, K3t, K2, K4 and (in the
    validation) K1 and K3 launched by both runs; the invariants of every
    native batch (`native_invariants`); the native and Python batches
    equal where both are deterministic (`layouts_equal`). Then
    `tools.sampler_bench` on the same dataset, and the simple_mlp
    baseline on the card against the CPU (`simple_mlp_card`). One line a
    backend: per
    epoch wait_s, step_s, valid_s and egonets/s, epoch 2's median step,
    the window's device idle share."""
    import numpy as np
    import torch
    from taxoexpan_torch import train as train_cli
    from taxoexpan_torch.ops import gat_kernels as gk
    from taxoexpan_torch.reference_scale_run import epoch_split
    from taxoexpan_torch.tools import make_synthetic_dataset, sampler_bench

    wrappers, required = _train_wrappers("PGAT")
    required += tuple(_eval_wrappers("PGAT"))
    runs, batches = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        work = Path(tmp)
        data = work / "mag_v2_30000.pickle.bin"
        t0 = time.time()
        taxonomy = make_synthetic_dataset.main(
            ["--out", str(data), *NATIVE_DATA])
        data_s = time.time() - t0
        for backend in NATIVE_BACKENDS:
            run = work / backend
            cfg = load_config("config.mag.json")
            for loader in ("train_data_loader", "validation_data_loader",
                           "test_data_loader"):
                cfg[loader]["args"].update(
                    data_path=str(data), backend=backend,
                    **slot_args(cfg))
            cfg["trainer"].update(epochs=NATIVE_EPOCHS,
                                  save_dir=str(run / "saved"),
                                  full_validation_every=0,
                                  tensorboardX=False, step_timing=True)
            run.mkdir()
            (run / "config.json").write_text(json.dumps(cfg))
            config = train_cli.parse_args(["-c", str(run / "config.json")])
            trainer_cls = train_cli.Trainer

            class ProfiledTrainer(trainer_cls):
                """The CLI's trainer with its profiler window on."""

                def __init__(self, *args, **kwargs):
                    super().__init__(*args, profile_dir=run / "profile",
                                     **kwargs)

            batches[backend] = []
            reset_counters()
            t0 = time.time()
            train_cli.Trainer = ProfiledTrainer
            try:
                with recorded_batches(batches[backend]):
                    log = train_cli.main(config)
            finally:
                train_cli.Trainer = trainer_cls
            torch.cuda.synchronize()
            train_s = time.time() - t0
            launches = path_launches("PGAT", wrappers)
            epochs = epoch_split((config.log_dir / "info.log").read_text())
            runs[backend] = {
                "backend": backend, "card": nvidia_smi_line(),
                "nodes": taxonomy.num_nodes, "train_s": train_s,
                "epochs": [{k: row.get(k) for k in (
                    "epoch", "loader", "loss", "wait_s", "step_s", "sync_s",
                    "valid_s", "egonets_per_sec", "epoch_seconds")}
                    for row in epochs],
                "steps_last_epoch": len(log.get("step_ms", [])),
                "median_step_ms_last_epoch": float(np.median(
                    log["step_ms"])),
                "val_macro_mr_last_epoch": log.get("val_macro_mr"),
                "profile": trace_split(run / "profile" / "trace.json"),
                "launches": launches}
            # ---- checks of the run
            if [row.get("loader") for row in epochs] != \
                    [backend] * NATIVE_EPOCHS:
                raise AssertionError(f"{backend} run: epochs ran on "
                                     f"{[r.get('loader') for r in epochs]}")
            losses = [row["loss"] for row in epochs]
            if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
                raise AssertionError(f"{backend} run: losses {losses}")
            for name in required:
                if launches[name] <= 0:
                    raise AssertionError(f"{backend} run never launched "
                                         f"{name}")
            emit("native_loader", **{k: v for k, v in runs[backend].items()
                                     if k != "profile"},
                 device_idle_share=runs[backend]["profile"][
                     "device_idle_share"],
                 profile_window_ms=runs[backend]["profile"]["wall_ms"])
        invariants = native_invariants(batches["native"])
        compared = layouts_equal(batches["native"], batches["python"])
        del batches
        bench = sampler_bench.main(["--data", str(data)])
        mlp = simple_mlp_card(data, device)
    res = {"card": nvidia_smi_line(), "dataset_s": data_s,
           "simple_mlp": mlp,
           "native_invariants": invariants, "layouts_compared": compared,
           "sampler_bench": bench,
           "median_step_ms_last_epoch": {
               b: runs[b]["median_step_ms_last_epoch"] for b in runs},
           "device_idle_share": {
               b: runs[b]["profile"]["device_idle_share"] for b in runs},
           "wait_s": {b: [e["wait_s"] for e in runs[b]["epochs"]]
                      for b in runs}}
    emit("native_loader_summary", **res)
    return runs


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs the port "
              "on a GPU only", file=sys.stderr)
        return 2
    if not (REPO / "taxoexpan_torch" / "ops" / "csrc").is_dir():
        print(f"chip_smoke: no taxoexpan_torch package beside {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from taxoexpan_torch.config import setup_logging
    setup_logging()          # the CLIs' stage timings, on stderr
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    info = phase_device()
    phase_build()
    phase_masks(device)
    kernels = run_paths(device)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(info["nvidia_smi"], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def reset_counters() -> None:
    """Every kernel wrapper's launch counts to 0: by dtype, by heads and by
    form (K1-K5, either dtype)."""
    from taxoexpan_torch.ops import gat_kernels as gk
    from taxoexpan_torch.ops import gcn_kernels as ck
    from taxoexpan_torch.ops import halo_kernels as hk
    for wrapper in (*gk.WRAPPERS.values(), *ck.WRAPPERS.values(),
                    *hk.WRAPPERS.values()):
        wrapper.launches = 0
    for wrapper in (*gk.WRAPPERS.values(), *ck.WRAPPERS.values()):
        wrapper.launches_bf16 = 0
    for wrapper in gk.WRAPPERS.values():
        wrapper.launches_by_heads = {}
    for wrapper in (*gk.WRAPPERS.values(), *ck.WRAPPERS.values()):
        wrapper.launches_by_form = {}


def run_paths(device) -> list[dict]:
    """The kernel, serving and training phases; returns the entries of the
    kernels line. A `phase_seconds` line gives each phase's wall time."""
    seconds: dict = {}

    def timed(name: str, fn, *args):
        t0 = time.time()
        out = fn(*args)
        seconds[name] = round(time.time() - t0, 1)
        return out
    cfg, _ = path_model("PGAT")
    drop = cfg["arch"]["args"]["feat_drop"]
    records = []
    for path in ("PGAT", "PGAT-bf16", "PGAT-concat", "PGAT-concat-bf16",
                 *CONFIG_PATHS):
        path_drop = load_config(PATHS[path][0])["arch"]["args"]["feat_drop"]
        records += timed(f"kernels {path}", phase_kernels, BATCH, device,
                         path_drop, path)
    records += timed("kernels tp", phase_tp_kernels, BATCH, device, drop)
    for path in ("PGCN", "PGCN-concat"):
        records += timed(f"kernels {path}", phase_gcn_kernels, BATCH, device,
                         path)
    mtl_cfg, _ = path_model("MTL")
    records += timed("kernels MTL", phase_mtl_kernels, BATCH, device,
                     mtl_cfg["arch"]["args"]["feat_drop"])
    records += timed("kernels halo", phase_halo_kernels, device, TRAIN_NODES,
                     BATCH, cfg["arch"]["args"]["in_dim"])
    records += timed("kernels MAG-Full", phase_mag_full_kernels, device)
    serving = {path: timed(f"serving {path}", phase_serving, device, NODES,
                           N_NOVEL, SEED, path) for path in SERVING_PATHS}
    # MAG-Full serving: its kernel entries read both CLIs' launches
    mag_full = timed("mag_full", phase_mag_full, device)
    serving["MAG-Full"] = {"launches": {
        name: sum(by_cli[name] for by_cli in mag_full["launches"].values())
        for name in mag_full["launches"]["test_fast"]}}
    training = {path: timed(f"training {path}", phase_training, device,
                            TRAIN_NODES, epochs, SEED, path)
                for path, epochs in TRAINING_PATHS.items()}
    training["PGAT-dp"] = timed(
        "dp_training", phase_dp_training, device, TRAIN_NODES, SEED,
        training["PGAT"]["median_step_ms"])
    tp = timed("tp_training", phase_tp_training, device, TRAIN_NODES, SEED,
               training["PGAT"]["median_step_ms"])
    timed("residual", phase_residual, device)
    timed("tp_concat", phase_tp_concat, device, SEED)
    # the host data path: PGAT's kernels again, driven through the native
    # loader (their entries below read that run's launches)
    native_runs = timed("native_loader", phase_native_loader, device)
    training["PGAT-native"] = {"launches": native_runs["native"]["launches"]}
    records += [dict(rec, name=rec["name"] + "[native_loader]",
                     path="PGAT-native")
                for rec in records if rec["path"] == "PGAT"]
    # the TP rows: each wrapper's launches at the shard's heads in the TP
    # runs, by dtype (float32 runs: the bf16 rows read 0); the pooled TP
    # form's rows read the pooled wrappers' count there (config.mag.json's
    # 1-head final layer runs whole, so it is 0)
    local = tp["heads_local"]
    for path, key in (("PGAT-tp", str(local)),
                      ("PGAT-tp-bf16", f"{local}[bf16]")):
        training[path] = training[path.replace("-tp", "-tp-pooled")] = {
            "launches": {name: by.get(key, 0) for name, by in
                         tp["launches_by_heads"].items()}}
    # the bf16 paths' median train step beside their float32 paths'
    emit("bf16_steps", card=nvidia_smi_line(), median_step_ms={
        path: training[path]["median_step_ms"]
        for path in ("PGAT", "PGAT-bf16", "MTL", "MTL-bf16")})
    # the concat paths' median train step beside their bias-mode paths'
    emit("concat_steps", card=nvidia_smi_line(), median_step_ms={
        path: training[path]["median_step_ms"]
        for path in ("PGAT", "PGAT-concat", "PGAT-bf16", "PGAT-concat-bf16",
                     "PGCN", "PGCN-concat")})
    # the other configuration files' median train step (64 groups a step)
    emit("config_steps", card=nvidia_smi_line(), median_step_ms={
        path: training[path]["median_step_ms"] for path in CONFIG_PATHS},
        egonets_per_step={path: training[path]["egonets_per_step"]
                          for path in CONFIG_PATHS})
    emit("phase_seconds", **seconds)
    kernels = []
    for rec in records:
        # eval forms: the serving path's launches; train forms and the
        # backwards: the training path's (of the record's path)
        path, wrapper = rec["path"], rec["wrapper"]
        phase = serving[path] if path in serving and \
            wrapper in serving[path]["launches"] else training[path]
        kernels.append({k: rec[k] for k in (
            "name", "route", "source", "replaces")} | {
            "launches": phase["launches"][rec.get("launch_key", wrapper)],
            **{k: rec[k] for k in ("max_abs_err", "ms", "plain_ms",
                                   "bound_ms", "bound_by", "library_ms")},
            **({"form": rec["form"]} if "form" in rec else {})})
    return kernels


if __name__ == "__main__":
    sys.exit(main())
