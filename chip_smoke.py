#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (flexflow_tpu_torch) on one GPU.

    python3 chip_smoke.py

1. prints the software versions and the card's name and power limit;
2. builds the CUDA kernels from ``flexflow_tpu_torch/csrc`` with nvcc,
   one nvcc per source, all started together;
3. kernel phase: holds the max-pool kernel against its plain PyTorch
   version (bit-equal) at the pool shapes of AlexNet, ResNet-50 and
   InceptionV3 and at edge cases (C not a multiple of the 16-byte
   vector, storage at an odd offset, a 12x12 window, ties of -0.0 and
   +0.0, 4096-wide rows, windows too large for the backward's tile), and
   times the kernel, the plain version and ``F.max_pool2d`` (the library
   yardstick; the port never calls it) with CUDA events;
4. backward kernel phase: the same for the max-pool backward kernels,
   with ``aten.max_pool2d_with_indices_backward`` as the yardstick; the
   large windows must take the window path (its launch count moves, the
   plain version never runs);
5. flash-attention phase: holds the forward and backward kernels
   against their plain versions (causal and not, s 512 and a ragged
   200, head dim 64 and 128, f32 and bf16; bf16 at head dim 100 and
   from unaligned storage, which the wrapper pads and copies for TMA;
   and BERT-base's own shape (16, 512, 12, 64) in bf16, causal and not),
   checks that two backward calls give the same bits, times both
   kernels at that shape, causal and not, beside
   ``F.scaled_dot_product_attention`` and its backward (and the host's
   time to enqueue a call), and splits the backward's device time by
   kernel;
6. LayerNorm phase: the fused LayerNorm kernel against its plain version
   and a float64 yardstick (residual or not, f32 and bf16, d 768, an odd
   d and a view at storage offset 1), its bf16 output bit-equal to its
   float32 output cast; timed in both output forms at BERT-base's shape
   beside the byte bound of each, an empty kernel on the same grid (the
   launch floor), ``F.layer_norm`` and the host's time per call;
7. AlexNet serving phase: serves full-width AlexNet (229x229, 10
   classes, bf16, random weights from seed 0) through ``ServingEngine``
   from two threads, checks the outputs, that the pool kernel ran 3
   times per dispatch (and the backward kernel never), and the model
   against its CPU twin in float32;
8. AlexNet training phase: trains full-width AlexNet (bf16, batch 64)
   through ``fit`` (2 epochs of 8 batches) and ``train_batch`` (10 steps
   on one batch, the loss must fall), checks that both pool kernels ran
   3 times per step, times a step and profiles it by kernel, and holds a
   float32 training step on the card against its CPU twin;
9. Transformer serving phase: serves BERT-base (12 layers, 768 wide, 12
   heads, d_ff 3072, s 512, vocab 30522, 2 classes, bf16, random weights
   from seed 0) through ``ServingEngine`` with batch buckets up to 16:
   the flash forward kernel runs 12 times and the LayerNorm kernel 24
   times per dispatch, the flash backward never;
10. Transformer training phase: trains the same model at batch 16 with
   Adam (alpha 1e-4) through ``fit``, then 24 ``train_batch`` steps on
   one batch (the loss must fall): 12 flash forward, 12 flash backward
   and 24 LayerNorm launches per step; times and profiles a step, and
   holds a small float32 Transformer training step on the card against
   its CPU twin;
11. generation phase: the fused LayerNorm kernel at a decode step's 16
   rows and a prefill chunk's (1, 256, 768) (checked and timed as in
   6), and the causal flash forward at (4, 1024, 12, 64), bf16, against
   their plain versions and timed; then serves a causal LM at GPT-2
   small's widths (12 x 768, 12 heads, d_ff 3072, 1024 positions, vocab
   50257, bf16, random weights from seed 0) through ``GenerationEngine``
   (16 slots, the auto pool of 1024 pages of 16 tokens, the prefix cache
   on, prefill chunks of 256): 32 greedy requests of 64 tokens
   (``GEN_NEW``, also the speculative phase's; prompts of 32-512 tokens,
   half behind one 256-token prefix), then 16 sampled ones: tokens/s,
   TTFT and TPOT, the pool's high-water and prefix hits, allocated KV
   bytes against ``kv_cache_bytes``, peak memory, 24 LayerNorm launches
   a dispatch and no flash launch; then, on the warm engine, the
   served greedy tokens against the full forward on the causal flash
   kernel, 4 new prompts x 16 tokens (two behind the cached prefix)
   whose every step's logits are held against it, and the same check
   with two deliberately wrong attentions as its controls (the mask
   off by one must fail it); the sampled requests in two fresh engines
   (the same tokens); a decode step's and a prefill chunk's device and
   wall time, and the decode step's kernels by the profiler (24 fewer
   than with the LayerNorm's float32 output and the op's cast); then a
   small float32 LSTM LM served on the card, its greedy tokens equal to
   the same engine's on the CPU;
11b. int8 serving phase: BERT-base as in 9 with ``serve_quantize="int8"``:
   ``memory_allocated`` falls by the quantizer's report within 1%, the
   served rows equal the quantized ``predict`` bit for bit (requests of
   a full bucket), their deviation from the bf16 model is printed, 12
   flash and 24 LayerNorm launches a dispatch, the int8 forward's
   profiler busy time and peak memory beside the bf16 forward's, the
   training verbs refused and a tampered report refused at warm-up;
11c. speculative generation phase: the LayerNorm kernel at the verify
   windows' (16, gamma, 768) rows against its plain version and timed;
   one full-width round enqueued with no host sync; then 8 greedy and
   4 sampled requests of the generation traffic through the plain
   engine and with two drafts: the target's own weights (gamma 4,
   fixed) and DistilGPT2's widths (6 x 768, seed 1, adaptive, demoted
   on accept collapse): tokens/s, TPOT, accept rates, draft
   dispatches, fallbacks, the draft pool's bytes and the memory freed
   by the demotion, LayerNorm launches against the rounds' reckoning;
   greedy tokens equal the plain run's up to a divergence where the
   plain top-2 gap is under 0.03 (the plain gaps' quantiles printed,
   and a verify shifted one position on as the control the check must
   flag), sampled streams replay in a fresh engine, and a float32 twin
   (2 layers) gives every plain token; the launches of the draft runs,
   the plain runs and the twin are reported as three paths;
12. average-pool phase: times the slice-add loop the port ran before and
   ``F.avg_pool2d`` (what the port runs now) at InceptionV3's 3x3/s1/p1
   pools and the two global pools;
13. ResNet-50 and InceptionV3 phases (224 and 299 px, 1000 classes, bf16,
   random weights from seed 0): serving through ``ServingEngine`` (1 and
   4 max-pool launches per dispatch), training at batch 64 with SGD
   through ``fit`` and ``train_batch`` (1 + 1 and 4 + 4 pool launches a
   step, the loss falls on a repeated batch), ResNet-50 with BatchNorm
   (every running statistic moves and ``evaluate`` reads them), and small
   float32 steps of each on the card against their CPU twins;
14. zoo phases (DLRM with four 1,000,000-row tables, batch 2048;
   CANDLE-Uno at its builder's defaults, batch 256; NMT, vocab 20000,
   2048 wide, 2 + 2 LSTM layers, 24 tokens, batch 256; bf16, random
   weights from seed 0, plain SGD): serving through ``ServingEngine``
   (buckets up to 2048, 256 and 32; 8 closed-loop clients, 2 rounds of
   100 requests, each round's rows/s and latency p50/p99), ``fit`` and
   10 ``train_batch`` steps on one batch (the mean of the last 3 losses
   under the first), a timed and profiled step
   (NMT's share of GEMM kernels); DLRM's tables on the sparse update
   path, 3 sparse steps held against 3 dense ones from the same weights
   (untouched rows bit-unchanged), both steps timed, and a batch with
   ids -1 and rows + 3 (no device assert, NaN only where the reference
   puts it); small float32 versions of the three, 3 steps on the card
   against their CPU twins.  No TPU kernel is on these paths: the five
   launch counts stay 0;
15. training-loop knob phases: BERT-base (bf16, batch 16) one step from
   one state without and with segmented remat (loss and parameters
   compared, predicted bit-equal; the step's peak memory must fall; the
   flash and LayerNorm launches against the segments' reckoning, forward
   launches in a checkpointed segment counting twice; a step's device
   time each way); BERT-base in float32 with gradient accumulation 2,
   without and with remat, against the full-batch step; ResNet-50 with
   BatchNorm (batch 64) through ``fit`` over 4 x 64 + 17 samples with
   accumulation 2, windows of 4 and the padded tail (finite losses, all
   96 running statistics move, 2 + 2 max-pool launches a step), then a
   ``train_window`` of 4 against 4 ``train_batch`` calls, bit for bit;
16. checkpoint phase: ResNet-50 with BatchNorm on the card, saved at step
   3 (synchronously, then with an async write overlapping training),
   loaded and trained on: bit-equal to the uninterrupted run;
   ``verify_checkpoint`` and a flipped byte; save and load times;
17. MoE phase: one MoE layer at BERT-base's width (8 experts, d_ff 3072,
   k 2, capacity 1.25, 4 x 512 tokens): forward, aux loss and gradients
   on the card against the CPU in float32, and its device times;
17a. pipeline phase: a ``pipeline_transformer_block`` of 12 stages at
   BERT-base's widths (batch 16, s 512, bf16, 4 microbatches) on one
   card: predict and a step, 24 LayerNorm launches each (the two
   ``ln(x + attn)`` sites a stage, on the kernel with its residual
   operand), the step's wall and busy time; one launch at the block's
   operands against the plain version; a float32 twin of 2 stages
   against the CPU;
17b. disaggregated serving phase (the two serving-fleet phases run
   last: see ``main``): the generation phase's LM behind the
   port's ``build_disagg`` (a prefill-role and a decode-role
   ``FleetEngine`` under a ``FleetRouter``, 16 slots each, pages of 16,
   chunks of 256, one copy of the parameters): the first 16 greedy
   prompts of the generation traffic x 32 tokens with the prefix cache
   off and on, each against one co-located engine of the same settings
   and submission order; tokens equal token for token, every stream
   migrated, ``migrated_bytes`` equal to the chains' pages x 589,824
   bytes (``kv_page_plan``'s page), both pools drained with the cache
   off, LayerNorm launches 24 a dispatch of either engine; export,
   handoff and import times and GB/s, TTFT and TPOT beside the
   co-located run's; one 32-page chain exported, copied and imported
   (read back bit-equal, one copy each way at the dispatcher, each
   leg timed); the prefill host's pacing against none, cache off, in
   one pair A B (tokens equal, wall, TTFT and TPOT of each run);
   ``FF_FAULT=migrate_fail_at:1`` (one ``serve_health`` fallback, that
   stream decodes co-located with equal tokens, nothing fails); a
   2-layer float32 twin (equal tokens, bit-equal pages); the kernels'
   launches of each kind of run stand apart in the ``kernels`` line
   (``disagg``: the two bf16 runs; ``disagg_pacing``, ``disagg_fault``,
   ``disagg_f32_check``), flash read from each (0: the paged attention
   is plain torch);
17c. fleet phase: BERT-base (dense ``ServingEngine``, bf16) and the LM
   (``GenerationEngine``) as two tenants of one ``FleetEngine``: the
   gate's residency bytes equal the tenants' tensor bytes, which equal
   the requested bytes of the blocks the allocator added, whose sizes
   (rounded up to 512 bytes, a large block keeping an unsplit remainder)
   equal the ``memory_allocated`` rise; 8 full-bucket BERT requests and 8 LM prompts x 32
   tokens served together: rows bit-equal and tokens equal to the
   standalone engines', each tenant's charged device seconds, 12 flash
   and 24 LayerNorm launches a BERT dispatch and 24 LayerNorm launches an
   LM dispatch;
17d. mesh phase: four ranks on the one card over gloo
   (``"cpu:gloo,cuda:gloo"``: NCCL refuses two ranks on one GPU), each
   on ``cuda:0``, run the multichip dryrun's CNN at {"n": 2, "c": 2} and
   a 2-layer transformer with the dryrun's strategies at {"s": 2, "c":
   2} (ring attention) and {"n": 2, "c": 2} (heads split), float32, one
   step each; full-width AlexNet (229 px, batch 64, bf16, conv on n,
   dense on n x c, 2 SGD steps) at {"n": 2, "c": 2}; BERT-base (bf16,
   batch 16, Adam 1e-4, 2 of its 12 layers) one step at {"n": 2, "c":
   2} and one at {"s": 2, "c": 2}; the pipeline block (bf16, 4 of its
   12 stages) at {"p": 4} (GPipe)
   and at {"n": 2, "p": 2} (interleaved, 2 chunks a rank) and their
   float32 twins (4 stages); the MoE of 17 at {"e": 4} and {"n": 2,
   "e": 2} and the dryrun's composed program (2 stages of a dense pair
   and an 8-expert MoE) at {"e": 2, "p": 2} with a smaller twin,
   float32.  Each rank counts
   each step's kernel launches (3 + 3 pool launches an AlexNet step; 2
   + 2 flash and 4 LayerNorm a 2-layer BERT step on 6 local heads; 4
   LayerNorm and no flash under the ring; 2 LayerNorm a stage a
   microbatch in a pipeline, whose ranks run nothing in a bubble), its
   step's wall and busy ms and its collectives (calls, bytes, and which
   were staged through pinned host memory); each rank's pools are
   bit-equal to the plain version on its shard.  Then this process runs
   each on one rank: the float32 mesh steps equal it within rtol 1e-4,
   the bf16 ones and the composed program (whose microbatches route
   otherwise than one rank's whole batch) within 15% by the L2 norm of
   the change (the first moment under Adam).  Beside those checks, a
   one-rank group on the default backend (NCCL): a {"n": 1} mesh step
   bit-equal to the step without a mesh; the ranks also reshard
   BERT-base (4 layers) in process and serve the sharded generation
   engine (the LM at 6 layers), and then compile BERT-base (bf16, 12
   layers) and its float32 twin (2 layers) with ``search_budget``: each
   rank searches the analytic objective for the four ranks, every
   rank's strategy equals the one this process searched (one digest,
   one exported file, the bf16 one byte for byte the search phase's
   file), and 2 steps on it are held to one rank (the twin at rtol
   1e-4, bf16 by the L2 share);
17e. search phase (before the mesh phase): the strategy search for 4
   devices on the native engine (asserted), ``optimize_strategies``
   through the objective it builds (the H100 spec): BERT-base and
   InceptionV3 at full width, analytic (best and data-parallel
   simulated step, proposals a second, wall seconds; BERT-base's
   strategy exported), then measure mode, each candidate partition of
   each op timed alone on the card with CUDA events: AlexNet (229 px,
   batch 64) launches both max-pool kernels and BERT-base at 2 layers
   the flash forward, backward and LayerNorm kernels (asserted; the
   ``search_measure_*`` paths of the ``kernels`` line), and the
   measured times against the spec's roofline by op type, the cache's
   partitions and seconds; the spec's launch time beside this run's
   floor;
17f. calibration phase (after the search phase): the calibrated cost
   model on the card.  ``harvest_ops`` times every op of full-width
   AlexNet (229 px, batch 64), BERT-base (batch 16) and InceptionV3
   (299 px, batch 64) in bf16 at partition degrees 1 and 2, each alone
   with CUDA events, into one ``CalibrationTable`` (no op skipped; the
   max-pool kernels launched on the CNNs, flash forward, backward and
   LayerNorm on BERT-base, asserted); ``harvest_train_dispatch`` reads
   each model's ``fit`` epoch events (``dispatch_ms``: the host's wall
   around a dispatch) and a power-law step correction is fit over the
   three; the table is saved, validated and reloaded to the same digest,
   its ``device_kind`` the card's; the error sweep re-times every op at
   degree 1 and a synchronized ``fit`` per model and reports per-op MAPE
   and end-to-end APE, analytic against the table and ridge estimators;
   BERT-base is searched for 4 devices on the table's objective
   (native engine asserted; best and data-parallel step under the table
   and the analytic roofline, the strategy digest); one ``search-bench``
   row on the table; the ``explain`` report of the calibrated strategy
   validates;
17g. frontends phase (after the calibration phase): the runner
   (``python -m flexflow_tpu_torch.cli``) started in subprocesses beside
   the rest: a script that trains (b) below for 2 steps under ``-b 64
   -e 1`` (its config's batch, its device cuda and its 2 + 2 pool
   launches a step, asserted), ``lint --model alexnet --json`` and
   ``explain --model transformer --mesh n=4 --json`` (device-free, the
   payloads checked); in this process (a) examples/python/native/
   alexnet_torch.py's AlexNet through ``nn_compat`` at its width (229
   px, batch 64, 10 classes, bf16): ``fit`` over 4 batches (3 + 3 pool
   launches a step) and ``predict`` (3), and its float32 twin, the same
   graph by FFModel's builder calls from the same weights, 2 SGD steps
   within 1e-6 (bit-equal expected); (b) examples/python/keras/
   func_cifar10_alexnet.py (3 x 32 x 32, batch 64) on
   ``keras.datasets.cifar10``'s synthetic fallback: its two pools (8 x 8
   x 64 and 4 x 4 x 192, 2 x 2 stride 2) held bit-equal to the plain
   version forward and backward in bf16 and f32, ``fit`` 4 steps (2 + 2
   a step) and ``evaluate`` (2 a batch); (c) a keras residual block at
   BERT-base's width (``Dense(3072, relu)``, ``Dense(768)``, ``Add``
   with the input, ``LayerNormalization``, ``Dense(2)``; 512 rows, bf16):
   the LayerNorm kernel against its plain version at (512, 768), then one
   launch a forward through ``fit`` and ``predict``, no flash launch.
   The ``kernels`` line carries the paths ``frontends_nn_alexnet``,
   ``frontends_keras_alexnet`` and ``frontends_keras_ln``;
17h. tooling phase (last): three subprocesses started first: (b) the
   runner with ``--metrics-port`` over a script that fits the full-width
   AlexNet (229 px, batch 64, bf16) for 2 steps and scrapes its own
   ``/metrics`` (valid exposition, the ``ff_train_*`` counters, 3 + 3
   pool launches a step), (c) the runner over a script that raises with
   ``FF_FLIGHT_DIR`` set (non-zero exit, one valid dump; ``flight dump``
   and ``flight show`` exit 0, ``flight dump`` on an empty directory
   1), (d) this file's ``--lockwatch`` workload under ``FF_LOCKWATCH=1``
   (AlexNet behind a ServingEngine, the GPT-2-small-width LM behind a
   GenerationEngine, a two-tenant FleetEngine round, one scrape: its
   runtime lock edges inside ``static_lock_edges()``, no cycle), with
   ``lint --concurrency`` (exit 0) run meanwhile; then in this process
   (a) BERT-base (12 x 768, s 512, batch 16, bf16) ``fit`` over 4 batches
   in windows of 2 under ``trace_dir`` and the span tracer: the
   profiler's file names the flash forward and backward and the
   LayerNorm kernels, 48 + 48 flash and 96 LayerNorm launches, 2
   ``train_window`` spans of 2 steps under one trace id, ``trace
   export`` of the saved spans exit 0 and valid, and the profiler's
   overhead (a step's busy and wall time with and without
   ``trace_dir``); (e) ``train-bench --ks 1,4,8,16 --steps 64 --epochs
   2``, ``precision-bench``, ``serve-bench --requests 256`` and
   ``serve-bench --overload --cell-seconds 0.5`` through the runner's
   verbs on the card (no hand-written kernel launches), their headline
   rows printed.  The ``kernels`` line carries ``tooling_bert_traced``
   and ``tooling_metrics_alexnet``;
17i. serving benches phase (after tooling): the runner's ``serve-bench
   --generate`` (48 requests: continuous against static batching,
   reference decode, the SLO sweep at 1x capacity), ``--generate
   --prefix``, ``--generate --speculate`` (8
   requests x 32 tokens, a 1-layer weight-shared draft), ``--fleet``
   (cells of 0.5 s) and ``--disagg``, in this process on the card, the
   LMs at GPT-2 small's depth and widths (12 x 768, 12 heads) over the
   benches' own 128-token vocabulary in float32; asserts each payload's
   logic booleans (parity, reconciliation, migration, the queue bound,
   the swap), records its timing booleans and headline readings, and
   counts the kernels: LayerNorm launches in the four LM benches, flash
   forward launches = 12 a forward of ``reference_decode``'s
   ``predict``, none in the fleet bench.  The ``kernels`` line carries
   ``serve_bench_generate``, ``serve_bench_prefix``,
   ``serve_bench_speculate``, ``serve_bench_disagg`` (LayerNorm) and
   ``serve_bench_generate_reference`` (flash forward);
17j. examples phase (after the serving benches): the repo's example
   scripts, unchanged, through the runner (``flexflow_tpu_torch.cli``),
   whose finder resolves their ``flexflow_tpu`` imports to the port: (a)
   examples/python/native/print_layers.py, print_input.py and
   tensor_attach.py with ``-b 64`` in subprocesses on the card (started
   before the frontends phase; each reads ``np.asarray(model.forward())``
   of a model on the card): exit 0, the ``logits`` lines and
   ``tensor_attach OK``, each one's seconds and its start-up (its
   seconds less a warm run of the same script through ``cli.main`` in
   this process); (b) alexnet.py (``-b 64 -e 1``: full-width AlexNet, 4
   steps) and apps/transformer.py (``-b 16 -e 1``: BERT-base, 4 steps)
   through ``cli.main`` in this process: 3 + 3 max-pool launches an
   AlexNet step, 12 + 12 flash and 24 LayerNorm launches a BERT-base
   step (the kernel phases hold each kernel against its plain version
   at these shapes).  The ``kernels`` line carries ``examples_alexnet``
   and ``examples_transformer``;
17k. capi phase (last): the C API over the port
   (``flexflow_tpu_torch/capi/``: capi/flexflow_tpu_c.cpp, unchanged,
   its imports wrapped onto the port at link time, built with g++ and no
   libpython; the build and (a)'s hosts
   started before the frontends phase): (a) capi/test_capi.c and
   capi/examples/alexnet.c (``-b 64 -e 1``, 64 px), unchanged, as C
   hosts linked with the library and libpython, on the card (exit 0,
   their lines, a finite final loss, their seconds to exit; the probe of
   ``sysconfig`` and g++ printed); the pool kernels at alexnet.c's three
   pool shapes and the LayerNorm kernel at test_capi.c's block's
   (8, 8, 16), bf16 and f32, against their plain versions (the block's
   attention, (8, 8, 2, 8), in the flash phase); (b) both programs
   again in this process (test_capi.c as its twin, whose files are
   relative paths), built as shared objects, ``main`` called through
   ctypes in the phase's directory: 15 + 15 max-pool launches (alexnet.c's warm-up and 4
   steps) and 12 + 12 flash and 24 LayerNorm (test_capi.c's 12 Adam
   steps of its block), a host's start-up its seconds less these; (c)
   test_capi.c's block at BERT-base's widths (batch 16, s 512, d 768,
   12 heads, causal, FFN 3072 gelu, vocab 30522, 4 classes) through the
   C functions (``capi/abi.py``): 4 bf16 Adam steps, their ms, 4 + 4
   flash and 8 LayerNorm launches, then one float32 step within 1e-5 of
   the same graph through the Python API from the same weights.  The
   ``kernels`` line carries ``capi_alexnet``, ``capi_test_transformer``
   and ``capi_bert_block``;
18. prints each phase's seconds, one ``kernels`` JSON line and, last,
   the ok line.

Any failure raises and exits non-zero before the ok line.  Needs one
CUDA device; exits 2 without one, or without the package beside it.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import os
import subprocess
import sys
import threading
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SEED = 0
BATCH = 64
# device memory bandwidth and the non-tensor-core float32 rate of an
# H100 SXM (NVIDIA data sheet), for the kernels' least possible time
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12
POOL_GEOM = ((3, 3), (2, 2), (0, 0))
# the max pools of one forward of each CNN at its input size, batch
# BATCH: (C, H, W) and (kernel, stride, padding)
MODEL_POOLS = {
    "alexnet": [((64, 56, 56), POOL_GEOM), ((192, 27, 27), POOL_GEOM),
                ((256, 13, 13), POOL_GEOM)],
    "resnet50": [((64, 112, 112), ((3, 3), (2, 2), (1, 1)))],
    "inception_v3": [((64, 147, 147), POOL_GEOM), ((192, 73, 73), POOL_GEOM),
                     ((288, 36, 36), POOL_GEOM), ((768, 17, 17), POOL_GEOM)],
}
# windows that the backward's tile cannot take, (N, C, H, W), geometry
# and dtypes: no tile of one pixel fits 227 KB of shared memory (f32
# past about 120 x 120, bf16/f16 past about 170 x 170 at stride 1), or
# more than 32767 window positions.  On no model's path: held and timed
LARGE_WINDOWS = [
    ("no tile fits", (1, 8, 256, 256), ((128, 128), (1, 1), (0, 0)),
     ("float32",)),
    ("no tile fits", (1, 8, 352, 352), ((172, 172), (1, 1), (0, 0)),
     ("bfloat16", "float16")),
    ("past 32767 positions", (1, 8, 192, 192), ((184, 184), (1, 1), (0, 0)),
     ("float32", "bfloat16", "float16")),
]
# the CNNs the smoke serves and trains: builder, input size, classes,
# max pools per forward
CNNS = {
    "alexnet": ("build_alexnet", 229, 10, 3),
    "resnet50": ("build_resnet50", 224, 1000, 1),
    "inception_v3": ("build_inception_v3", 299, 1000, 4),
}
# InceptionV3's branch pools (3x3 / s1 / p1) and the two global pools,
# (C, H, W, k, p) at batch BATCH, bf16: the average-pool timing shapes
AVG_POOLS = [(192, 36, 36, 3, 1), (256, 36, 36, 3, 1), (288, 36, 36, 3, 1),
             (768, 17, 17, 3, 1), (1280, 8, 8, 3, 1), (2048, 8, 8, 3, 1),
             (2048, 7, 7, 7, 0), (2048, 8, 8, 8, 0)]
# ResNet-50 and InceptionV3 training: batches of fit's one epoch, and
# steps of the repeated-batch check
CNN_FIT_BATCHES = 4
CNN_REPEAT_STEPS = 10
# ResNet-50 with BatchNorm, float32 card step against its CPU twin: the
# loss within this relative error, the running statistics within this
# share of their largest value, and the parameters' difference within
# this share of the step's update, both as L2 norms over all trainable
# parameters.  From random weights its stem's gradient is a
# near-cancelling sum through 48 BatchNorm backward passes, so float32
# runs of this step that sum in another order (the CPU's and the card's)
# lie several percent of the update apart, about as far as either lies
# from a float64 run (PERF.md, PR 6)
BN_LOSS_RTOL = 1e-4
BN_STATS_RTOL = 1e-3
BN_CARD_L2_SHARE = 0.15
TRAIN_BATCHES = 8
TRAIN_EPOCHS = 2
# float32 training step, card against CPU: largest difference allowed
# in the loss and in any updated parameter
F32_STEP_TOL = 1e-4
# dense bf16 tensor-core rate of an H100 SXM (NVIDIA data sheet): the
# least time for the flash kernels' operations in bf16
BF16_OPS_PER_S = 989e12
# BERT-base (examples/apps/transformer.py) and the smoke's batch: a
# quarter of the default 64, to keep the run inside its time limit
BERT = dict(num_layers=12, d_model=768, num_heads=12, d_ff=3072,
            seq_len=512, vocab_size=30522, num_classes=2)
BERT_BATCH = 16
# steps of the repeated-batch check (see transformer_train_phase)
REPEAT_STEPS = 24
# the sequence and recommendation zoo at bench.py's configurations:
# DLRM with four 1,000,000-row tables of 64, bag 1, batch 2048, SGD 0.01
# (mlp_top[0] is the interaction's width, 64 + 4 x 64: the builders'
# default of 576 does not build); CANDLE-Uno at its builder's defaults,
# batch 256, SGD 0.001; NMT (BASELINE.md config 4), batch 256, SGD 0.01,
# served at batch buckets up to 32
DLRM = dict(embedding_size=(1_000_000,) * 4, sparse_feature_size=64,
            embedding_bag_size=1, mlp_bot=(256, 512, 64),
            mlp_top=(320, 512, 256, 1))
NMT = dict(vocab_size=20000, embed_dim=2048, hidden_dim=2048, num_layers=2,
           src_len=24, tgt_len=24)
ZOO = {  # builder, its arguments, training batch, serving batch, SGD lr
    "dlrm": ("build_dlrm", DLRM, 2048, 2048, 0.01),
    "candle_uno": ("build_candle_uno", {}, 256, 256, 0.001),
    "nmt": ("build_nmt", NMT, 256, 32, 0.01),
}
# serving: ZOO_CLIENTS client threads, each sending one request at a
# time and the next when it returns, ZOO_REQUESTS requests a round over
# ZOO_ROUNDS rounds (400 a round until the calibration phase needed the
# time, 200 until the examples phase did); sizes log-uniform from 1 row
# to the serving batch, drawn once, so the rounds repeat one load.
# The rows of the first ZOO_CHECKED requests are held against predict()
ZOO_CLIENTS = 8
ZOO_REQUESTS = 100
ZOO_ROUNDS = 2
ZOO_CHECKED = 32
ZOO_FIT_BATCHES = 4
ZOO_REPEAT_STEPS = 10
# DLRM's sparse steps against its dense steps on the card: every
# parameter within this.  The paths add the same terms; index_add_ sums
# a duplicate id's rows with atomics, the dense gradient in its own order
SPARSE_DENSE_TOL = 1e-6
# small float32 versions of the zoo for the card-against-CPU steps
ZOO_SMALL = {
    "dlrm": dict(embedding_size=(1000, 2000, 3000, 4000),
                 sparse_feature_size=16, mlp_bot=(32, 64, 16),
                 mlp_top=(80, 64, 32, 1)),
    "candle_uno": dict(dense_layers=(64, 32), dense_feature_layers=(64, 64),
                       feature_shapes={"dose": 1, "cell.rnaseq": 64,
                                       "drug.descriptors": 128,
                                       "drug.fingerprints": 96}),
    "nmt": dict(vocab_size=500, embed_dim=64, hidden_dim=64, num_layers=2,
                src_len=12, tgt_len=12),
}
# flash attention against its plain version (TF32 off): f32 outputs
# and gradients within these; bf16 within FLASH_LOW_TOL of the largest
# reference value.  The kernel sums in another order: not bit-equal
FLASH_F32_OUT_TOL = 2e-5
FLASH_F32_GRAD_TOL = 1e-4
FLASH_LOW_TOL = 2e-2
# bf16/f16 beside that: the forward's worst row, its largest error over
# its largest reference value (each causal row attends to its own count
# of keys, so rows differ in scale), and for O and each gradient the
# RMS of the error over the RMS of the reference.  About twice the
# largest readings on an H100 (worst row 0.0077, RMS 0.0028, PERF.md)
FLASH_LOW_ROW_TOL = 1.6e-2
FLASH_LOW_RMS_TOL = 6e-3
# the forward's float32 natural-log lse against the plain one
FLASH_LSE_TOL = 1e-4
# the bf16/f16 flash kernels' design, and the times at BERT-base's shape
# (not causal) of the mma.sync design they replaced: quoted from PERF.md
# (kernel table row 4; H100 80GB HBM3 at 700 W), not measured here
FLASH_DESIGN = "wgmma+tma"
FLASH_EARLIER_MS_QUOTED = {"fwd": 0.1519, "bwd": 0.6989}
# the LayerNorm kernel's design, and the times (bf16 in, f32 out) of the
# warp-a-row shared-memory design it replaced, at 8192 rows and at a
# decode step's and a chunk's rows: quoted from PERF.md (kernel table row
# 3; H100 80GB HBM3 at 700 W), not measured here, and printed only in the
# timing lines' text
LN_DESIGN = "row in registers, 16-byte vectors, threads a row by (rows, d)"
LN_EARLIER_MS_QUOTED = {8192: 0.0158, 16: 0.0062, 256: 0.0066}
# LayerNorm, in units in the last place of the output's largest value
# (at least 1): the kernel against the float64 function and against the
# plain version, whose float32 statistics reduce in another order
LN_MAX_ULPS_EXACT = 4
LN_MAX_ULPS_PLAIN = 4
# the max-pool kernels' design, and the per-pool times at AlexNet's three
# pools (bf16, batch 64) of the scalar design they replaced: quoted from
# PERF.md (kernel table rows 1-2; H100 80GB HBM3 at 700 W), not measured here
POOL_DESIGN = {"fwd": "16-byte channel vectors, shared columns reused",
               "bwd": "one fused tile pass (cp.async, shared-memory "
                      "argmax, gather)",
               "window": "window path (int32 argmax scratch, then "
                         "gather)"}
POOL_EARLIER_MS_QUOTED = {"fwd": [0.0544, 0.0396, 0.0155],
                          "bwd": [0.2186, 0.1563, 0.0524]}


# the training-loop knobs (PERF.md, PR 8).  BERT-base under remat: one
# step from one state with remat off and on, SGD at this rate; the loss
# and every parameter must be bit-equal (the recomputed kernels see the
# same inputs, and the flash backward has no atomics)
REMAT_LR = 1e-3
# BERT-base in float32, gradient accumulation 2 (with and without remat)
# against the full-batch step: loss and every parameter within this.  The
# microbatch gradients add in another order than one batch's sum, about
# 1e-6 of a gradient, times the rate
ACCUM_LR = 0.01
ACCUM_TOL = 1e-5
# ResNet-50 (batch_norm=True) under the knobs: fit over KNOBS_SAMPLES
# samples (4 full batches and a tail of 17) with accumulation 2, windows of
# 4 and the padded tail; then a window of 4 against 4 train_batch calls
KNOBS_SAMPLES = 4 * BATCH + 17
# SGD (momentum 0.9) for the knobs' and the checkpoint's ResNet-50: from
# random weights its gradients reach the thousands, so a small rate keeps
# the steps finite (batchnorm_phase)
KNOBS_LR = 1e-5
KNOBS_ACCUM = 2
KNOBS_WINDOW = 4
# one MoE layer at BERT-base's width on 4 x 512 tokens: C = 640, the
# (T, E, C) one-hot 42 MB in float32.  Card against the CPU in float32:
# outputs, aux loss, loss and gradients, and one train_batch's loss and
# parameter updates, within MOE_TOL of the largest reference value
# (float32 einsums over at most 3072 terms summed in another order; the
# routing must pick the same experts)
MOE = dict(num_experts=8, d_ff=3072, k=2, capacity_factor=1.25)
MOE_SHAPE = (4, 512, 768)
MOE_TOL = 1e-4

# strategies on one card (PERF.md, PR 9).  Strategy files are written
# under the build directory and imported through
# FFConfig.import_strategy_file
STRATEGY_DIR = os.path.join(HERE, "build", "strategies")
# DLRM's dense (every-row) host update under SGD with momentum: steps
# timed
HETERO_DENSE_STEPS = 2
# BERT-base in a float32 session with its 12 attention ops pinned to bf16,
# against the unpinned float32 run from the same weights: the two class
# probabilities within PIN_VS_F32_TOL.  A bf16 attention rounds q, k, v
# and its output to 8 significant bits (2^-9 relative each); LayerNorm
# renormalises every layer, so 12 layers move a logit by about 12 x 2^-9
# x 4 (q, k, v, out) ~ 9% of its size at worst, and a probability by at
# most a quarter of the logits' difference's change
PIN_VS_F32_TOL = 5e-2
# the same strategy at small width: the card (flash kernels, bf16)
# against the CPU (the dense path in bf16), FLASH_LOW_TOL of the largest
# value as the kernels' own bf16 comparison, on the logits of a float32
# session whose attention alone is bf16
PIN_SMALL = dict(num_layers=2, d_model=128, num_heads=2, d_ff=256,
                 seq_len=128, vocab_size=1000, num_classes=2)
# the committed searched strategies and their models (the builders'
# widths, the file's batch and device count), verified device-free
SEARCHED = [
    ("searched_inception_v3_b128_8dev.pb", "build_inception_v3", 128, 8),
    ("searched_inception_v3_b128_32dev.pb", "build_inception_v3", 128, 32),
    ("searched_nmt_b256_8dev.pb", "build_nmt", 256, 8),
    ("searched_transformer_b8_8dev.pb", "build_transformer", 8, 8),
    ("searched_transformer_b32_8dev.pb", "build_transformer", 32, 8),
]
# every full-width training step's peak device memory beside the
# verifier's analytic high-water for it (memory_estimate)
MEMORY = []
# paged token generation at GPT-2 small's published widths (Hugging Face
# gpt2: n_layer 12, n_embd 768, n_head 12, n_positions 1024, vocab_size
# 50257) in the repo's post-norm block, bf16, random weights from SEED;
# 16 slots, pages of 16 tokens (the auto pool: 1024 pages), the prefix
# cache on, prefill chunks of 256
GPT2 = dict(num_layers=12, d_model=768, num_heads=12, d_ff=3072,
            seq_len=1024, vocab_size=50257)
GEN_SLOTS = 16
GEN_PAGE = 16
GEN_CHUNK = 256
# traffic: GEN_REQUESTS greedy requests of GEN_NEW new tokens, prompts
# of 32-512 tokens, half of them behind one shared 256-token prefix; then
# 16 sampled ones.  GEN_REQUESTS was 64 and GEN_NEW (the generation and
# speculative phases' tokens a request) 128 until the frontends phase
# needed the time; the other phases take the first prompts, the same
# whatever GEN_REQUESTS is
GEN_REQUESTS = 32
GEN_PROMPT = (32, 512)
GEN_PREFIX = 256
GEN_NEW = 64
GEN_SAMPLED = 16
GEN_SAMPLING = dict(temperature=0.8, top_k=50, top_p=0.95)
# prompts x tokens whose every step's logits are held against the full
# forward, and the tolerances on those logits; tokens must be equal
# where the reference's top-2 gap exceeds them.  Each limit lies between
# two readings on an H100 (PERF.md): the sound run's largest
# error and the smallest error of a deliberately wrong attention that
# leaves the noise.  bf16: the paged path attends in plain torch where
# the reference runs the flash kernel, and every op rounds to bf16 (a
# logit near 1 is one ulp, 0.0078, from its neighbour): sound 0.0088,
# wrong 1.168 (attending another slot's pages; a mask off by one and
# bf16 scores stay inside the rounding).  float32: sound 1.4e-6, wrong
# 1.1e-4 (bf16 scores) and up
# the LSTM LM's decode, card against CPU: a small float32 LM (the JAX
# package serves it whole-prompt, no prefix cache), greedy requests
LSTM_GEN = dict(vocab_size=97, embed_dim=64, hidden_dim=128, num_layers=2,
                seq_len=64)
LSTM_GEN_PROMPTS = 6
LSTM_GEN_NEW = 16
GEN_CHECKED = (4, 16)
GEN_LOGIT_TOL = 0.03
GEN_F32_LOGIT_TOL = 1e-5
# int8 weight-only serving: BERT-base as in the transformer phase with
# serve_quantize="int8" (its 2-D Linear kernels int8 with float32
# per-output-channel scales); the resident bytes must fall as the
# quantizer's report says, within this share
QUANT_DROP_TOL = 0.01
# the served traffic: requests of a full bucket, so each dispatch is one
# request and predict() sees the same batches
QUANT_REQUESTS = 4
# speculative generation: the generation phase's target (GPT2 above,
# same engine settings) with two drafts: (a) its own weights, gamma
# SPEC_GAMMA, fixed (every proposal verifies but for bf16 near-ties);
# (b) DistilGPT2's published widths (Hugging Face distilgpt2: n_layer 6,
# n_embd 768, n_head 12, n_positions 1024, vocab_size 50257) from seed 1
# under the adaptive policy: random weights disagree, so the
# correction, the collapse guard and the demotion run
DISTILGPT2 = dict(num_layers=6, d_model=768, num_heads=12, d_ff=3072,
                  seq_len=1024, vocab_size=50257)
SPEC_GAMMA = 4
# traffic: the first SPEC_REQUESTS greedy prompts of gen_traffic x
# GEN_NEW tokens, then SPEC_SAMPLED sampled ones.  16 and 8 until the
# serving benches phase needed the time: its serve-bench --generate
# --speculate holds greedy speculation to plain decode token for token
# and replays the sampled arm (8 requests saved 7.7 s on an H100 80GB
# HBM3 at 700 W, PERF.md)
SPEC_REQUESTS = 8
SPEC_SAMPLED = 4
# the float32 twin: the target and the DistilGPT2 draft at this depth,
# SPEC_F32_REQUESTS x SPEC_F32_NEW greedy tokens; every token must equal
# plain greedy decode's
SPEC_F32_LAYERS = 2
SPEC_F32_REQUESTS = 8
SPEC_F32_NEW = 32
# the control of the bf16 check: the self-draft engine with its verify
# window shifted one position on (each row then sees the next row's K/V
# and the next position's embedding), SPEC_CONTROL_NEW tokens a
# request; the check must flag it
SPEC_CONTROL_NEW = 32

# disaggregated serving: the generation phase's LM (GPT2 above) behind
# the port's build_disagg (a prefill-role and a decode-role FleetEngine
# under a FleetRouter, 16 slots each, pages of 16, prefill chunks of 256,
# sharing the model's parameters on the card), against one co-located
# engine of the same settings; the first DISAGG_REQUESTS greedy prompts
# of gen_traffic x DISAGG_NEW tokens, the prefix cache off and on.  A page
# is 2 (K, V) x 12 layers x 16 tokens x 12 heads x 64 x 2 bytes.
# DISAGG_REQUESTS was 32 and DISAGG_NEW 64 until the serving benches
# phase needed the time: its serve-bench --disagg runs the colo and
# disagg arms at GPT-2 small's widths with token parity (prefix cache on
# and off), reconciliation and every stream migrated (16 requests saved
# 18.3 s on an H100 80GB HBM3 at 700 W, PERF.md)
DISAGG_REQUESTS = 16
DISAGG_PAGE_BYTES = 2 * 12 * 16 * 12 * 64 * 2
# the bf16 runs' tokens a request (GEN_NEW until the calibration phase
# needed the time, 64 until the serving benches phase did) and the
# pacing arms' pairs after the first run
DISAGG_NEW = 32
DISAGG_PACING_PAIRS = 1
# the float32 twin: GPT2's widths at this depth, the first
# DISAGG_F32_REQUESTS prompts x DISAGG_F32_NEW tokens
DISAGG_F32_LAYERS = 2
DISAGG_F32_REQUESTS = 8
DISAGG_F32_NEW = 32
# the fault run: FF_FAULT=migrate_fail_at:1 over this many prompts
DISAGG_FAULT_REQUESTS = 4
# the fleet: BERT-base (the transformer phase's model, bf16) as a dense
# tenant and the generation LM as a generation tenant under one
# FleetEngine; FLEET_BERT_REQUESTS requests of a full bucket (one
# dispatch each) and the first FLEET_GEN_REQUESTS prompts x
# FLEET_GEN_NEW tokens, submitted together
FLEET_BERT_REQUESTS = 8
FLEET_GEN_REQUESTS = 8
FLEET_GEN_NEW = 32
# the CUDA caching allocator rounds every block up to this many bytes
ALLOC_ROUND = 512
# decode steps a profiler window counts kernels over (generation phase)
PROFILED_STEPS = 5


def card_line() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def bits(t):
    import torch
    view = {torch.float32: torch.int32, torch.bfloat16: torch.int16,
            torch.float16: torch.int16}[t.dtype]
    return t.view(view)


def rms_rel(got, want) -> float:
    """RMS of ``got - want`` over the RMS of ``want``, in float32."""
    w = want.float()
    return float((got.float() - w).norm() / w.norm().clamp_min(1e-30))


def assert_bit_equal(a, b, what: str) -> float:
    """Same NaN positions and the same bits everywhere else; returns
    the max abs difference over the non-NaN values (0.0)."""
    import torch
    assert a.shape == b.shape and a.dtype == b.dtype, what
    na, nb = torch.isnan(a), torch.isnan(b)
    assert torch.equal(na, nb), f"{what}: NaN positions differ"
    ba = torch.where(na, torch.zeros_like(bits(a)), bits(a))
    bb = torch.where(nb, torch.zeros_like(bits(b)), bits(b))
    assert torch.equal(ba, bb), f"{what}: kernel and plain version differ"
    d = (a.float() - b.float()).abs()
    return float(d[~na].max()) if (~na).any() else 0.0


def rotation(x, min_bytes: int = 128 << 20):
    """Copies of ``x`` covering ``min_bytes``, so that timing loops that
    cycle through them find the 50 MB L2 cache cold."""
    import torch
    n = max(1, -(-min_bytes // (x.numel() * x.element_size())))
    fmt = (torch.channels_last if x.dim() == 4
           else torch.contiguous_format)
    return [x.clone(memory_format=fmt) for _ in range(n)]


def time_ms(fn, xs, iters: int, spin_cycles: int = 200_000_000,
            warmup: int = 3) -> float:
    """Device time per call: a GPU spin first lets the host enqueue
    every call before the GPU reaches them, so the events time GPU
    work and not host launch overhead.  The spin must outlast the
    host's enqueueing of all ``iters`` calls."""
    import torch
    for i in range(warmup):
        fn(xs[i % len(xs)])
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(spin_cycles)
    start.record()
    for i in range(iters):
        fn(xs[i % len(xs)])
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def host_us(fn, xs, iters: int, spin_cycles: int = 200_000_000) -> float:
    """Host time per call to enqueue ``fn`` (wall time of ``iters`` calls
    queued behind a GPU spin, so no call waits for the device)."""
    import torch
    torch.cuda.synchronize()
    torch.cuda._sleep(spin_cycles)
    t0 = time.perf_counter()
    for i in range(iters):
        fn(xs[i % len(xs)])
    wall = time.perf_counter() - t0
    torch.cuda.synchronize()
    return wall / iters * 1e6


def kernel_breakdown(fn, steps: int, card: str, what: str = "forward",
                     counts: dict = None) -> list:
    """Device time by kernel over ``steps`` calls of ``fn`` (torch
    profiler), and the device's busy share of the window's wall time;
    returns the (kernel name, device µs over all calls) rows, and fills
    ``counts``, when given, with each kernel's launches over the calls
    (copies and memsets left out).
    When ``counts`` is given, one more call runs first in the profiler's
    warm-up, whose events are dropped: a window that starts with the
    tracing itself gained or lost a pinned upload and compare kernels on
    an H100, which are not launches of the counted calls."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    warm = counts is not None
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=(schedule(wait=0, warmup=1, active=1, repeat=1)
                           if warm else None)) as prof:
        if warm:
            fn()
            torch.cuda.synchronize()
            prof.step()
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # a schedule's step annotation spans the device's timeline too, and
    # is no kernel
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and e.self_device_time_total > 0
              and not e.key.startswith("ProfilerStep")]
    rows = [(e.key, e.self_device_time_total) for e in events]
    if counts is not None:
        # kernels only: the profiler's device copies come and go between
        # runs of one process on an H100 (see host_copies)
        counts.update({e.key: e.count for e in events
                       if not e.key.startswith(("Memcpy", "Memset"))})
    total = sum(t for _, t in rows)
    if not total:
        print("kernel breakdown: the profiler saw no device time "
              "(not measured)")
        return []
    rows.sort(key=lambda r: -r[1])
    print(f"kernel breakdown over {steps} {what}s: device busy "
          f"{total / steps / 1e3:.3f} ms per {what}, "
          f"{100 * total / wall_us:.1f}% of the wall time of the "
          f"{steps} back-to-back calls [{card}]")
    for name, t in rows[:10]:
        print(f"  {100 * t / total:5.1f}%  {t / steps / 1e3:8.4f} ms  "
              f"{name[:90]}")
    return rows


def rand_input(shape, dtype, gen, kind="normal"):
    """A channels-last input on the card: normal values, small integers
    ("ties"), small integers with half the zeros -0.0 ("zeros"), normal
    values with 1% NaN and 1% -inf ("nan"), or normal values in a
    channels-last view at storage offset 1 ("unaligned")."""
    import torch

    dev = torch.device("cuda")
    if kind in ("ties", "zeros"):
        x = torch.randint(-2, 3, shape, generator=gen, device=dev).float()
        if kind == "zeros":
            half = torch.rand(shape, generator=gen, device=dev) < 0.5
            x = torch.where((x == 0) & half, -0.0, x)
    else:
        x = torch.randn(shape, generator=gen, device=dev)
    x = x.to(dtype).contiguous(memory_format=torch.channels_last)
    if kind == "nan":
        m = torch.rand(shape, generator=gen, device=dev) < 0.01
        x = x.masked_fill(m, float("nan"))
        m = torch.rand(shape, generator=gen, device=dev) < 0.01
        x = x.masked_fill(m, float("-inf"))
        x = x.contiguous(memory_format=torch.channels_last)
    if kind == "unaligned":
        n, c, h, w = shape
        buf = torch.empty(x.numel() + 1, dtype=dtype, device=dev)
        view = buf.as_strided(shape, (h * w * c, 1, w * c, c), 1)
        view.copy_(x)
        assert view.is_contiguous(memory_format=torch.channels_last)
        assert view.data_ptr() % 16 != 0
        x = view
    return x


def pool_edge_cases():
    """Cases of both pool phases that the 16-byte path does not fit (a
    narrower instance of the same kernel takes them), a window of 144
    positions (past the backward's int8 argmax), windows whose max is a
    zero held with both signs (the forward keeps the first zero's bits),
    and rows too wide for one backward tile (bands of columns)."""
    import torch
    zeros = [(f"signed-zero ties {str(dt).replace('torch.', '')}",
              (8, 64, 27, 27), dt, ((3, 3), (2, 2), (1, 1)), "zeros")
             for dt in (torch.bfloat16, torch.float16, torch.float32)]
    wide = [(f"4096-wide rows {str(dt).replace('torch.', '')}",
             (2, 64, 6, 4096), dt, POOL_GEOM, "nan")
            for dt in (torch.bfloat16, torch.float32)]
    return zeros + wide + [
        ("C not a multiple of 8", (8, 36, 27, 27), torch.bfloat16,
         ((3, 3), (2, 2), (1, 1)), "nan"),
        ("storage at offset 1", (8, 64, 27, 27), torch.bfloat16,
         POOL_GEOM, "unaligned"),
        ("storage at offset 1 f32", (4, 40, 15, 15), torch.float32,
         ((3, 3), (2, 2), (1, 1)), "unaligned"),
        ("12x12 window (int16 argmax)", (4, 16, 30, 30), torch.float16,
         ((12, 12), (4, 4), (2, 2)), "nan"),
    ]


def pool_quoted(which: str, i: int) -> str:
    return (f" (earlier design, scalar loads"
            f"{', two passes' if which == 'bwd' else ''}: "
            f"{POOL_EARLIER_MS_QUOTED[which][i]} ms, quoted from PERF.md, "
            f"not measured in this run)")


def dtype_of(name: str):
    import torch
    return getattr(torch, name)


def model_pool_cases():
    """Every model pool at batch BATCH, in bf16 and f32."""
    import torch
    return [(f"{model} {c}x{h}x{w}", (BATCH, c, h, w), dtype, geom, "normal")
            for dtype in (torch.bfloat16, torch.float32)
            for model, pools in MODEL_POOLS.items()
            for (c, h, w), geom in pools]


def large_window_cases():
    return [(f"{what} {geom[0][0]}x{geom[0][1]} window", shape,
             dtype_of(dt), geom, "nan")
            for what, shape, geom, dts in LARGE_WINDOWS for dt in dts]


@contextlib.contextmanager
def plain_refused(cuda_pool):
    """The plain backward raises while the block runs: a kernel wrapper
    that gave way to it on the card would fail."""
    plain = cuda_pool.max_pool_nhwc_backward_reference

    def refuse(*args):
        raise AssertionError("the plain max-pool backward ran on the card")

    cuda_pool.max_pool_nhwc_backward_reference = refuse
    try:
        yield
    finally:
        cuda_pool.max_pool_nhwc_backward_reference = plain


def pool_bounds(in_b: int, out_b: int, ops: int):
    bytes_s = (in_b + out_b) / HBM_BYTES_PER_S
    ops_s = ops / SCALAR_OPS_PER_S
    return (max(bytes_s, ops_s) * 1e3,
            "bytes" if bytes_s >= ops_s else "operations")


def pool_timing_rows(cuda_pool, gen, shapes, iters, plain_iters):
    """Forward timing rows, one per (label, (N, C, H, W), (k, s, p)),
    bf16 unless the label says otherwise."""
    import torch
    import torch.nn.functional as F

    rows = []
    for label, shape, dtype, (k, s, p) in shapes:
        n, c, h, w = shape
        x = rand_input(shape, dtype, gen)
        xs = rotation(x)
        y = cuda_pool.max_pool_nhwc(x, k, s, p)
        in_b = x.numel() * x.element_size()
        out_b = y.numel() * y.element_size()
        bound_ms, bound_by = pool_bounds(in_b, out_b,
                                         y.numel() * (k[0] * k[1] - 1))
        kernel_ms = time_ms(lambda t: cuda_pool.max_pool_nhwc(t, k, s, p),
                            xs, iters)
        rows.append({
            "model": label, "shape": [n, h, w, c],
            "dtype": str(dtype).replace("torch.", ""), "window": list(k),
            "stride": list(s), "padding": list(p),
            "design": POOL_DESIGN["fwd"],
            # the channels per access of the last timed launch
            "vec": cuda_pool.max_pool_nhwc.last_vec,
            "kernel_ms": kernel_ms,
            # a plain version timed once (the large windows': 1.4-7.3 s a
            # call) takes no warm-up call, which would double its cost:
            # the checks already ran it at this shape
            "plain_ms": time_ms(
                lambda t: cuda_pool.max_pool_nhwc_reference(t, k, s, p),
                xs, plain_iters, warmup=min(3, plain_iters - 1)),
            "library_ms": time_ms(
                lambda t: F.max_pool2d(t, k, s, p), xs, iters),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "bytes": in_b + out_b,
        })
        del xs
    torch.cuda.synchronize()
    return rows


def kernel_phase(cuda_pool, gen) -> dict:
    import torch

    cases = model_pool_cases() + [
        ("padded", (8, 32, 13, 13), torch.bfloat16,
         ((3, 3), (2, 2), (1, 1)), "normal"),
        ("pad > kernel/2", (2, 8, 9, 9), torch.float32,
         ((3, 3), (1, 1), (2, 2)), "normal"),
        ("asymmetric k/s/p", (4, 16, 7, 9), torch.float16,
         ((3, 2), (1, 2), (0, 1)), "normal"),
        ("windows miss the tail", (2, 24, 10, 10), torch.bfloat16,
         ((3, 3), (3, 3), (0, 0)), "normal"),
        ("tie-heavy", (16, 64, 28, 28), torch.bfloat16,
         ((3, 3), (2, 2), (1, 1)), "ties"),
        ("NaN and -inf", (8, 64, 27, 27), torch.bfloat16,
         ((3, 3), (2, 2), (1, 1)), "nan"),
        ("NaN f32", (4, 40, 15, 15), torch.float32,
         ((2, 2), (2, 2), (0, 0)), "nan"),
    ] + pool_edge_cases() + large_window_cases()
    max_err = 0.0
    for name, shape, dtype, (k, s, p), kind in cases:
        x = rand_input(shape, dtype, gen, kind)
        y = cuda_pool.max_pool_nhwc(x, k, s, p)
        torch.cuda.synchronize()
        ref = cuda_pool.max_pool_nhwc_reference(x, k, s, p)
        torch.cuda.synchronize()
        err = assert_bit_equal(y, ref, f"{name} {dtype}")
        max_err = max(max_err, err)
        print(f"kernel == plain (bit-equal): {name} {tuple(shape)} "
              f"{str(dtype).replace('torch.', '')} k={k} s={s} p={p}")

    shapes = pool_timing_rows(
        cuda_pool, gen, [(model, (BATCH,) + chw, torch.bfloat16, geom)
                         for model, pools in MODEL_POOLS.items()
                         for chw, geom in pools], 200, 20)
    for i, row in enumerate(shapes):
        print("pool timing: " + json.dumps(row)
              + (pool_quoted("fwd", i) if i < 3 else ""))
    large = pool_timing_rows(
        cuda_pool, gen, [(what, shape, dtype_of(dts[0]), geom)
                         for what, shape, geom, dts in LARGE_WINDOWS], 5, 1)
    for row in large:
        print("pool timing (large window): " + json.dumps(row))
    return {"max_abs_err": max_err, "shapes": shapes, "large": large}


def pool_backward_timing_rows(cuda_pool, gen, shapes, iters, plain_iters):
    """Backward timing rows, as pool_timing_rows."""
    import torch
    import torch.nn.functional as F

    rows = []
    for label, shape, dtype, (k, s, p) in shapes:
        n, c, h, w = shape
        x = rand_input(shape, dtype, gen)
        oh, ow = cuda_pool.out_hw(h, w, k, s, p)
        g = rand_input((n, c, oh, ow), dtype, gen)
        _, idx = F.max_pool2d(x, k, s, p, return_indices=True)
        x_b = x.numel() * x.element_size()
        g_b = g.numel() * g.element_size()
        # copies covering 128 MB, as rotation() does for the forward
        pairs = [(x.clone(memory_format=torch.channels_last),
                  g.clone(memory_format=torch.channels_last))
                 for _ in range(max(1, -(-(128 << 20) // (x_b + g_b))))]
        # read x, read g, write dx; per window: k*k - 1 compares to find
        # its max, one add
        bound_ms, bound_by = pool_bounds(x_b + g_b, x_b,
                                         g.numel() * k[0] * k[1])
        kernel_ms = time_ms(
            lambda t: cuda_pool.max_pool_nhwc_backward(*t, k, s, p),
            pairs, iters)
        plan = cuda_pool.max_pool_nhwc_backward.last_plan
        rows.append({
            "model": label, "shape": [n, h, w, c],
            "dtype": str(dtype).replace("torch.", ""), "window": list(k),
            "stride": list(s), "padding": list(p),
            "design": (POOL_DESIGN["bwd"] if isinstance(
                plan, cuda_pool.BackwardPlan) else POOL_DESIGN["window"]),
            # the route (tile and channels per access) of the last timed
            # launch
            "tile": dict(plan._asdict(), route=type(plan).__name__),
            "kernel_ms": kernel_ms,
            # no warm-up for a plain version timed once, as in
            # pool_timing_rows
            "plain_ms": time_ms(
                lambda t: cuda_pool.max_pool_nhwc_backward_reference(
                    *t, k, s, p), pairs, plain_iters,
                warmup=min(3, plain_iters - 1)),
            "library_ms": time_ms(
                lambda t: torch.ops.aten.max_pool2d_with_indices_backward(
                    t[1], t[0], list(k), list(s), list(p), [1, 1], False,
                    idx), pairs, iters),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "bytes": 2 * x_b + g_b,
        })
        del pairs
    torch.cuda.synchronize()
    return rows


def backward_kernel_phase(cuda_pool, gen) -> dict:
    """The backward kernels against their plain version, bit-equal (the
    large windows through the window path), then timed at every model
    pool (bf16, batch 64) and at the large windows."""
    import torch

    def grad_for(x, k, s, p):
        n, c, h, w = x.shape
        oh, ow = cuda_pool.out_hw(h, w, k, s, p)
        return rand_input((n, c, oh, ow), x.dtype, gen)

    cases = model_pool_cases() + [
        ("padded", (8, 32, 13, 13), torch.bfloat16,
         ((3, 3), (2, 2), (1, 1)), "normal"),
        ("pad > kernel/2", (2, 8, 9, 9), torch.float32,
         ((3, 3), (1, 1), (2, 2)), "normal"),
        ("asymmetric k/s/p", (4, 16, 7, 9), torch.float16,
         ((3, 2), (1, 2), (0, 1)), "normal"),
        ("windows miss the tail", (2, 24, 10, 10), torch.bfloat16,
         ((3, 3), (3, 3), (0, 0)), "normal"),
        ("stride 1 (9 windows per element)", (4, 64, 17, 17),
         torch.float16, ((3, 3), (1, 1), (1, 1)), "normal"),
        ("tie-heavy", (16, 64, 28, 28), torch.bfloat16,
         ((3, 3), (2, 2), (1, 1)), "ties"),
        ("NaN and -inf", (8, 64, 27, 27), torch.bfloat16,
         ((3, 3), (2, 2), (1, 1)), "nan"),
        ("NaN f32", (4, 40, 15, 15), torch.float32,
         ((2, 2), (2, 2), (0, 0)), "nan"),
    ] + pool_edge_cases()
    max_err = 0.0
    bwd = cuda_pool.max_pool_nhwc_backward
    for large, (name, shape, dtype, (k, s, p), kind) in (
            [(False, c) for c in cases]
            + [(True, c) for c in large_window_cases()]):
        x = rand_input(shape, dtype, gen, kind)
        g = grad_for(x, k, s, p)
        before = bwd.window_launches
        with plain_refused(cuda_pool):
            dx = bwd(x, g, k, s, p)
            torch.cuda.synchronize()
        window = bwd.window_launches - before
        assert window == int(large), (name, window)
        ref = cuda_pool.max_pool_nhwc_backward_reference(x, g, k, s, p)
        torch.cuda.synchronize()
        err = assert_bit_equal(dx, ref, f"backward {name} {dtype}")
        max_err = max(max_err, err)
        print(f"backward kernel == plain (bit-equal): {name} "
              f"{tuple(shape)} {str(dtype).replace('torch.', '')} "
              f"k={k} s={s} p={p}"
              + (" (window path: argmax + gather launches)" if window
                 else ""))

    shapes = pool_backward_timing_rows(
        cuda_pool, gen, [(model, (BATCH,) + chw, torch.bfloat16, geom)
                         for model, pools in MODEL_POOLS.items()
                         for chw, geom in pools], 200, 20)
    for i, row in enumerate(shapes):
        print("pool backward timing: " + json.dumps(row)
              + (pool_quoted("bwd", i) if i < 3 else ""))
    large = pool_backward_timing_rows(
        cuda_pool, gen, [(what, shape, dtype_of(dts[0]), geom)
                         for what, shape, geom, dts in LARGE_WINDOWS], 5, 1)
    for row in large:
        print("pool backward timing (large window): " + json.dumps(row))
    return {"max_abs_err": max_err, "shapes": shapes, "large": large}


def avg_pool_slice_loop(x, kernel, stride, padding):
    """The average pool as the port ran it before this slice: the sum of
    the kh*kw strided window views of the zero-padded input, in float32,
    over kh*kw.  Kept here only to time it against F.avg_pool2d."""
    import torch.nn.functional as F
    from flexflow_tpu_torch.ops import cuda_pool

    n, c, h, w = x.shape
    (ph, pw) = padding
    oh, ow = cuda_pool.out_hw(h, w, kernel, stride, padding)
    xp = F.pad(x.float(), (pw, pw, ph, ph))
    acc = None
    for win in cuda_pool.window_slices(xp, kernel, stride, (oh, ow)):
        acc = win if acc is None else acc + win
    return (acc / (kernel[0] * kernel[1])).to(x.dtype)


def avg_pool_phase(gen, card: str) -> list:
    """The slice-add loop the port ran before and F.avg_pool2d at
    InceptionV3's 3x3/s1/p1 pools and the global pools (bf16, batch 64,
    channels-last): times, and the two forms' largest difference."""
    import torch
    import torch.nn.functional as F

    rows = []
    for c, h, w, k, p in AVG_POOLS:
        x = rand_input((BATCH, c, h, w), torch.bfloat16, gen)
        xs = rotation(x)
        geom = ((k, k), (1, 1), (p, p))
        new = F.avg_pool2d(x, k, 1, p, count_include_pad=True)
        old = avg_pool_slice_loop(x, *geom)
        in_b = x.numel() * x.element_size()
        out_b = new.numel() * new.element_size()
        row = {
            "shape": [BATCH, h, w, c], "dtype": "bf16", "window": k,
            "padding": p,
            "avg_pool2d_ms": time_ms(
                lambda t: F.avg_pool2d(t, k, 1, p, count_include_pad=True),
                xs, 100),
            "slice_loop_ms": time_ms(
                lambda t: avg_pool_slice_loop(t, *geom), xs, 20),
            "bound_ms": (in_b + out_b) / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes",
            "max_abs_diff": float((new.float() - old.float()).abs().max()),
            "avg_pool2d_channels_last": new.is_contiguous(
                memory_format=torch.channels_last),
        }
        rows.append(row)
        print("avg pool timing: " + json.dumps(row) + f" [{card}]")
        del xs
    return rows


def build_cnn(ft, name: str, cfg, device=None, **kwargs):
    from flexflow_tpu_torch import models

    builder, image, classes, _ = CNNS[name]
    return getattr(models, builder)(cfg, classes, image, device=device,
                                    **kwargs)


def serve_phase(ft, cuda_pool, card: str, name: str = "alexnet") -> int:
    """Serve a full-width CNN; returns the pool kernel's launches during
    the serving run."""
    import numpy as np

    _, image, classes, pools = CNNS[name]
    cfg = ft.FFConfig(batch_size=BATCH, compute_dtype="bfloat16", seed=SEED)
    model, _, _ = build_cnn(ft, name, cfg)   # on cuda
    model.compile()
    t0 = time.perf_counter()
    model.init_layers(seed=SEED)
    print(f"{name}: {model.num_parameters} parameters, layout "
          f"{model.resolved_conv_layout}, init "
          f"{time.perf_counter() - t0:.3f}s")
    t0 = time.perf_counter()
    engine = ft.ServingEngine(model, max_batch=BATCH)
    print(f"engine warmup ({len(engine.buckets)} buckets): "
          f"{time.perf_counter() - t0:.3f}s")

    rng = np.random.default_rng(SEED)
    sizes = ([[1, 17, 64, 3, 40, 100, 8, 2, 64, 33],
              [3, 64, 5, 130, 16, 1, 64, 48, 7, 64]] if name == "alexnet"
             else [[1, 17, 64, 3, 40, 8], [3, 64, 5, 33, 7, 2]])
    reqs = [[rng.standard_normal((n, 3, image, image)).astype(np.float32)
             for n in ss] for ss in sizes]
    results = [[None] * len(ss) for ss in sizes]

    def producer(t: int) -> None:
        futs = [engine.submit(x) for x in reqs[t]]
        for i, f in enumerate(futs):
            results[t][i] = f.result(timeout=300)

    cuda_pool.max_pool_nhwc.launches = 0
    cuda_pool.max_pool_nhwc_backward.launches = 0
    t0 = time.perf_counter()
    with engine:
        threads = [threading.Thread(target=producer, args=(t,))
                   for t in range(len(sizes))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
            assert not th.is_alive(), "producer thread did not finish"
        wall = time.perf_counter() - t0
        stats = engine.stats()
    launches = cuda_pool.max_pool_nhwc.launches
    assert cuda_pool.max_pool_nhwc_backward.launches == 0, \
        "serving launched the backward kernel"

    n_req = sum(len(s) for s in sizes)
    rows = sum(sum(s) for s in sizes)
    assert stats["requests"] == n_req and stats["errors"] == 0, stats
    assert stats["submitted"] == (
        stats["requests"] + stats["rejected"] + stats["shed"]
        + stats["expired"] + stats["errors"] + stats["cancelled"]), stats
    assert launches == pools * stats["dispatches"] > 0, (launches, stats)
    xs = np.concatenate([x for r in reqs for x in r])
    ys = np.concatenate([y for r in results for y in r])
    assert ys.shape == (rows, classes), ys.shape
    assert np.isfinite(ys).all(), "non-finite outputs"
    np.testing.assert_allclose(ys.sum(axis=1), 1.0, atol=1e-2)
    # the same rows through predict: other batch compositions, so bf16
    # rounding may differ in the last bits of a probability
    ref = model.predict(xs, batch_size=BATCH)
    err = float(np.abs(ys - ref).max())
    assert err <= 1e-2, f"engine vs predict max abs err {err}"
    print(f"{name} serve: {n_req} requests ({rows} rows) from {len(sizes)} "
          f"threads, {stats['dispatches']} dispatches, pool launches "
          f"{launches} (= {pools} x dispatches), {rows / wall:.1f} rows/s, "
          f"p50 {stats['p50_ms']} ms, p99 {stats['p99_ms']} ms, "
          f"engine vs predict max abs err {err:.3g} [{card}]")

    # one bucket-64 forward with its input already on the card: device
    # time, then device time by kernel
    x64 = model._to_device((xs[:BATCH],))
    fwd = model.forward_compiled(BATCH)
    fwd_ms = time_ms(lambda t: fwd(model._params, t), [x64], 20,
                     spin_cycles=1_000_000_000)
    print(f"{name} forward at batch {BATCH} (bf16): {fwd_ms:.4f} ms device "
          f"time; engine dispatch (pack + forward + fetch) mean "
          f"{stats['dispatch_ms']} ms wall [{card}]")
    kernel_breakdown(lambda: fwd(model._params, x64), 5, card)
    if name != "alexnet":
        return launches

    # float32 full-width AlexNet on the card against its CPU twin (same
    # seed, so the same weights): kernel path vs plain path end to end
    cfg32 = ft.FFConfig(batch_size=4, compute_dtype="float32", seed=SEED)
    outs = []
    for device in ("cuda", "cpu"):
        m, _, _ = build_cnn(ft, name, cfg32, device=device)
        m.compile()
        m.init_layers(seed=SEED)
        outs.append(m.predict(xs[:4]))
    err32 = float(np.abs(outs[0] - outs[1]).max())
    assert err32 <= 1e-4, f"f32 cuda vs cpu max abs err {err32}"
    print(f"f32 AlexNet cuda (nhwc, kernel) vs cpu (nchw, plain): max abs "
          f"err {err32:.3g} on probabilities")
    return launches


class EpochLosses:
    """fit() callback that keeps every epoch's per-step losses."""

    def __init__(self):
        self.epochs = []

    def set_model(self, model):
        self.model = model

    def on_train_begin(self):
        pass

    def on_epoch_begin(self, epoch):
        pass

    def on_epoch_end(self, epoch, perf_metrics):
        self.epochs.append(self.model.last_epoch_losses.copy())

    def on_train_end(self):
        pass


def train_phase(ft, cuda_pool, card: str, name: str = "alexnet") -> dict:
    """Train a full-width CNN on the card; returns both pool kernels'
    launches during the fit() run."""
    import numpy as np
    import torch

    _, image, classes, pools = CNNS[name]
    alexnet = name == "alexnet"
    batches, epochs = ((TRAIN_BATCHES, TRAIN_EPOCHS) if alexnet
                       else (CNN_FIT_BATCHES, 1))
    metrics = ["accuracy", "sparse_categorical_crossentropy"]
    cfg = ft.FFConfig(batch_size=BATCH, compute_dtype="bfloat16", seed=SEED)
    model, _, _ = build_cnn(ft, name, cfg)   # on cuda
    # the reference alexnet.cc trains with SGD at lr 0.001
    model.compile(ft.SGDOptimizer(lr=0.001), metrics=metrics)
    model.init_layers(seed=SEED)
    t0 = time.perf_counter()
    xs, y = ft.synthetic_dataset(batches * BATCH, [(3, image, image)],
                                 (1,), num_classes=classes, seed=SEED)
    print(f"{name} train data: {batches} batches of {BATCH} made in "
          f"{time.perf_counter() - t0:.3f}s")

    record = EpochLosses()
    out = io.StringIO()
    cuda_pool.max_pool_nhwc.launches = 0
    cuda_pool.max_pool_nhwc_backward.launches = 0
    cuda_pool.max_pool_nhwc_backward.window_launches = 0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        model.fit(xs, y, epochs=epochs, callbacks=[record])
    fit_s = time.perf_counter() - t0
    launches = {"fwd": cuda_pool.max_pool_nhwc.launches,
                "bwd": cuda_pool.max_pool_nhwc_backward.launches}
    text = out.getvalue()
    print(text, end="")
    steps = batches * epochs
    assert model._step == steps, model._step
    assert launches == {"fwd": pools * steps, "bwd": pools * steps}, launches
    assert cuda_pool.max_pool_nhwc_backward.window_launches == 0
    for e in range(epochs):
        assert f"epoch {e}: accuracy: " in text, text
    assert "ELAPSED TIME = " in text and "THROUGHPUT = " in text, text
    fit_losses = np.concatenate(record.epochs)
    assert fit_losses.shape == (steps,), fit_losses.shape
    assert np.isfinite(fit_losses).all(), fit_losses
    print(f"{name} fit: {steps} steps, pool launches {launches['fwd']} "
          f"forward + {launches['bwd']} backward (= {pools} + {pools} per "
          f"step), losses {np.round(fit_losses, 4).tolist()}, {fit_s:.3f}s "
          f"wall [{card}]")

    # one batch, repeated steps with momentum: the loss must fall.  The
    # deeper nets without BatchNorm diverge from random weights at
    # AlexNet's rate, so they take a tenth of it
    repeat, lr = (10, 0.01) if alexnet else (CNN_REPEAT_STEPS, 0.001)
    model.compile(ft.SGDOptimizer(lr=lr, momentum=0.9), metrics=metrics)
    model.init_layers(seed=SEED)
    xb = torch.from_numpy(xs[0][:BATCH]).to(model.device)
    yb = torch.from_numpy(y[:BATCH]).to(model.device)
    losses = torch.stack([model.train_batch(xb, yb) for _ in range(repeat)])
    losses = losses.cpu().numpy()
    assert np.isfinite(losses).all(), losses
    assert losses[0] > losses[-1], f"loss did not fall: {losses}"
    print(f"{name} train_batch x{repeat} on one batch (SGD lr {lr}, "
          f"momentum 0.9): loss {losses[0]:.4f} -> {losses[-1]:.4f} "
          f"({np.round(losses, 4).tolist()})")

    # one step with the batch already on the card: device time, wall
    # time, then device time by kernel.  The spin (about 1.1 s, or 1.6 s
    # for the deeper nets) must outlast the host's enqueueing of the
    # timed steps
    timed = 10 if alexnet else 5
    step_ms = time_ms(lambda b: model.train_batch(*b), [(xb, yb)], timed,
                      spin_cycles=2_000_000_000 if alexnet
                      else 3_000_000_000)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(timed):
        model.train_batch(xb, yb)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / timed
    print(f"{name} training step at batch {BATCH} (bf16): {step_ms:.4f} ms "
          f"device time, {wall_ms:.4f} ms wall per step over {timed} steps "
          f"[{card}]")
    kernel_breakdown(lambda: model.train_batch(xb, yb), 3 if alexnet else 2,
                     card, what="training step")
    step_memory(model, (xb, yb), f"{name} step (bf16, batch {BATCH}, SGD "
                f"momentum)", card)
    del model
    torch.cuda.empty_cache()
    if alexnet:
        alexnet_f32_step_check(ft, xs, y, metrics)
    return launches


def alexnet_f32_step_check(ft, xs, y, metrics) -> None:
    """A float32 full-width AlexNet training step on the card against its
    CPU twin (same seed, so the same weights and batch)."""
    import numpy as np

    cfg32 = ft.FFConfig(batch_size=2, compute_dtype="float32", seed=SEED)
    results = []
    for device in ("cuda", "cpu"):
        m, _, _ = build_cnn(ft, "alexnet", cfg32, device=device)
        m.compile(ft.SGDOptimizer(lr=0.01, momentum=0.9), metrics=metrics)
        m.init_layers(seed=SEED)
        loss = float(m.train_batch(xs[0][:2], y[:2]))
        results.append((loss, {p.name: m.get_weights(p.name)
                               for p in m.parameters}, m))
    (loss_c, w_c, m_c), (loss_h, w_h, _) = results
    assert m_c.resolved_conv_layout == "nhwc"
    loss_err = abs(loss_c - loss_h)
    param_err = max(float(np.abs(w_c[k] - w_h[k]).max()) for k in w_h)
    assert loss_err <= F32_STEP_TOL and param_err <= F32_STEP_TOL, (
        loss_err, param_err)
    print(f"f32 AlexNet training step cuda (nhwc, kernels) vs cpu (nchw, "
          f"plain): loss {loss_c:.6f} vs {loss_h:.6f} (abs err "
          f"{loss_err:.3g}), max abs err over the updated parameters "
          f"{param_err:.3g} (tolerance {F32_STEP_TOL})")


def batchnorm_phase(ft, cuda_pool, card: str) -> None:
    """Full-width ResNet-50 with BatchNorm (bf16, batch 64): a few
    train_batch steps move every running statistic, and evaluate reads
    them (putting them back to their initial values changes its loss)."""
    import numpy as np
    import torch

    _, image, classes, pools = CNNS["resnet50"]
    cfg = ft.FFConfig(batch_size=BATCH, compute_dtype="bfloat16", seed=SEED)
    model, _, _ = build_cnn(ft, "resnet50", cfg, batch_norm=True)
    # from random weights its gradients reach the thousands: a small rate
    # keeps the few steps finite
    model.compile(ft.SGDOptimizer(lr=1e-4), metrics=["accuracy"])
    model.init_layers(seed=SEED)
    stats = [p.name for p in model.parameters if not p.trainable]
    assert len(stats) == 2 * 48, len(stats)
    start = {k: model._params[k].clone() for k in stats}
    xs, y = ft.synthetic_dataset(BATCH, [(3, image, image)], (1,),
                                 num_classes=classes, seed=SEED)
    cuda_pool.max_pool_nhwc.launches = 0
    cuda_pool.max_pool_nhwc_backward.launches = 0
    steps = 3
    losses = torch.stack([model.train_batch(xs[0], y)
                          for _ in range(steps)]).cpu().numpy()
    assert np.isfinite(losses).all(), losses
    assert (cuda_pool.max_pool_nhwc.launches,
            cuda_pool.max_pool_nhwc_backward.launches) == (
                pools * steps, pools * steps)
    unmoved = [k for k in stats if torch.equal(model._params[k], start[k])]
    assert not unmoved, f"running statistics did not move: {unmoved}"
    assert all(model._params[k].dtype == torch.float32 for k in stats)
    loss, _ = model.evaluate(xs[0], y, batch_size=BATCH)
    trained = {k: model._params[k] for k in stats}
    model._params.update(start)
    loss_init, _ = model.evaluate(xs[0], y, batch_size=BATCH)
    model._params.update(trained)
    assert np.isfinite(loss) and loss != loss_init, (loss, loss_init)
    print(f"resnet50 batch_norm=True: {steps} train_batch steps (losses "
          f"{np.round(losses, 4).tolist()}), all {len(stats)} running "
          f"statistics moved; evaluate loss {loss:.4f} with them, "
          f"{loss_init:.4f} with the initial ones [{card}]")


def trimmed_inception(ft, cfg, device):
    """InceptionV3's stem cut to one conv, then one module of each kind
    (A at 8 pool features, C at 8 channels) at 75 px: two max pools (in
    B and D), the branch avg pools, the concats and the head."""
    from flexflow_tpu_torch.models import inception

    m = ft.FFModel(cfg, device=device)
    inp = m.create_tensor((cfg.batch_size, 3, 75, 75), name="input")
    t = m.conv2d(inp, 8, 3, 3, 2, 2, 0, 0, activation="relu")
    t = inception._inception_a(m, t, 8)
    t = inception._inception_b(m, t)
    t = inception._inception_c(m, t, 8)
    t = inception._inception_d(m, t)
    t = inception._inception_e(m, t)
    hw = t.shape[2]
    t = m.pool2d(t, hw, hw, 1, 1, 0, 0, pool_type="avg")
    t = m.flat(t)
    logits = m.dense(t, 10)
    m.softmax(logits)
    return m, inp, logits


def cnn_f32_step_checks(ft, cuda_pool) -> None:
    """Small float32 training steps on the card (kernels) against their
    CPU twins (plain versions): ResNet-50 with BatchNorm at 64 px (to the
    BatchNorm bounds above) and the trimmed InceptionV3 (within
    F32_STEP_TOL).  The held card step runs PyTorch's own convolutions
    (cuDNN off): cuDNN's float32 algorithms put 9.86e-5 into the trimmed
    InceptionV3's stem gradient where PyTorch's agree within 1.5e-8
    (PERF.md, PR 6), so the cuDNN step is printed beside it, not held.
    Every check runs before any failure is raised."""
    import numpy as np
    import torch
    from flexflow_tpu_torch.models import build_resnet50

    rng = np.random.default_rng(SEED)
    checks = [
        ("ResNet-50 batch_norm=True, 64 px",
         lambda cfg, dev: build_resnet50(cfg, 1000, 64, True,
                                         device=dev)[0],
         dict(image=64, classes=1000, pools=1, lr=0.01, momentum=0.0)),
        ("trimmed InceptionV3, 75 px",
         lambda cfg, dev: trimmed_inception(ft, cfg, dev)[0],
         dict(image=75, classes=10, pools=2, lr=0.01, momentum=0.9)),
    ]
    failed = []
    for label, build, o in checks:
        x = rng.standard_normal((2, 3, o["image"], o["image"])).astype(
            np.float32)
        y = rng.integers(0, o["classes"], (2, 1)).astype(np.int32)
        runs = {}
        for device, cudnn in (("cpu", True), ("cuda", False),
                              ("cuda", True)):
            cfg = ft.FFConfig(batch_size=2, compute_dtype="float32",
                              seed=SEED)
            with torch.backends.cudnn.flags(enabled=cudnn, benchmark=False,
                                            deterministic=False,
                                            allow_tf32=False):
                m = build(cfg, device)
                m.compile(ft.SGDOptimizer(lr=o["lr"],
                                          momentum=o["momentum"]))
                m.init_layers(seed=SEED)
                w0 = {p.name: m.get_weights(p.name).astype(np.float64)
                      for p in m.parameters}
                reset_counts(cuda_pool.max_pool_nhwc,
                             cuda_pool.max_pool_nhwc_backward)
                loss = float(m.train_batch(x, y))
            if device == "cuda":
                assert m.resolved_conv_layout == "nhwc"
                assert (cuda_pool.max_pool_nhwc.launches,
                        cuda_pool.max_pool_nhwc_backward.launches) == (
                            o["pools"], o["pools"])
            runs[(device, cudnn)] = (loss, {
                p.name: m.get_weights(p.name).astype(np.float64)
                for p in m.parameters})
        loss_h, w_h = runs[("cpu", True)]
        stats = [p.name for p in m.parameters if not p.trainable]
        trainable = [k for k in w_h if k not in stats]
        update = np.sqrt(sum(((w_h[k] - w0[k]) ** 2).sum()
                             for k in trainable))
        for cudnn in (False, True):
            loss_c, w_c = runs[("cuda", cudnn)]
            loss_err = abs(loss_c - loss_h)
            param_err = max(float(np.abs(w_c[k] - w_h[k]).max())
                            for k in trainable)
            if stats:
                l2 = float(np.sqrt(sum(((w_c[k] - w_h[k]) ** 2).sum()
                                       for k in trainable)) / update)
                stats_err = max(float(np.abs(w_c[k] - w_h[k]).max()
                                      / np.abs(w_h[k]).max()) for k in stats)
                ok = (loss_err <= BN_LOSS_RTOL * abs(loss_h)
                      and l2 <= BN_CARD_L2_SHARE
                      and stats_err <= BN_STATS_RTOL)
                result = (f"parameters' difference {l2:.3g} of the "
                          f"update (L2), running statistics {stats_err:.3g} "
                          f"of their largest (tolerances: loss "
                          f"{BN_LOSS_RTOL} relative, parameters "
                          f"{BN_CARD_L2_SHARE}, running statistics "
                          f"{BN_STATS_RTOL})")
            else:
                ok = loss_err <= F32_STEP_TOL and param_err <= F32_STEP_TOL
                result = f"(tolerance {F32_STEP_TOL})"
            held = "held" if not cudnn else "printed, not held"
            print(f"f32 {label} training step cuda (nhwc, kernels, cuDNN "
                  f"{'on' if cudnn else 'off'}: {held}) vs cpu (nchw, "
                  f"plain): loss {loss_c:.6f} vs {loss_h:.6f} (abs err "
                  f"{loss_err:.3g}), max abs err over the updated "
                  f"parameters {param_err:.3g}, {result}")
            if not ok and not cudnn:
                failed.append((label, loss_err, param_err))
    assert not failed, failed


def flash_bounds(n, sq, sk, h, d, itemsize, causal, backward):
    """The least time of one flash call: the larger of its bytes over
    the memory rate and its operations over the bf16 tensor-core rate
    (the f32 rate for float32).  Forward: 4 n h sq sk d operations, q,
    k, v, o moved once plus the lse; backward: 2.5x the forward's
    operations, q, k, v, o, dO read and dq, dk, dv written plus the lse.
    Causal runs need half the operations."""
    ops = 4 * n * h * sq * sk * d * (2.5 if backward else 1.0)
    if causal:
        ops /= 2
    q_b = n * sq * h * d * itemsize
    kv_b = n * sk * h * d * itemsize
    lse_b = n * h * sq * 4
    moved = (3 * q_b + 5 * kv_b if backward else 2 * q_b + 2 * kv_b) + lse_b
    rate = BF16_OPS_PER_S if itemsize < 4 else SCALAR_OPS_PER_S
    bytes_s, ops_s = moved / HBM_BYTES_PER_S, ops / rate
    return (max(bytes_s, ops_s) * 1e3,
            "bytes" if bytes_s >= ops_s else "operations", moved, ops)


def flash_phase(cuda_attention, gen, card: str) -> dict:
    """Both flash kernels against their plain versions, then timed at
    BERT-base's shapes (16, 512, 12, 64) in bf16, and the backward's
    device time split by kernel."""
    import torch
    import torch.nn.functional as F

    dev = gen.device

    def rand(shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def check(shape, dtype, causal, errs, label="", unaligned=False):
        n, s, h, d = shape
        if unaligned:   # views 2 bytes into their storage
            size = n * s * h * d
            buf = rand((3 * size + 1,), dtype)
            q, k, v = (buf[1 + i * size:1 + (i + 1) * size].view(shape)
                       for i in range(3))
            assert q.data_ptr() % 16 != 0
        else:
            q, k, v = (rand(shape, dtype) for _ in range(3))
        scale = d ** -0.5
        low = dtype != torch.float32
        o, lse = cuda_attention.flash_attention_forward(q, k, v, causal, scale)
        torch.cuda.synchronize()
        ref = cuda_attention.flash_attention_reference(q, k, v, causal, scale)
        diff = (o.float() - ref).abs()
        err = float(diff.max())
        tol = (FLASH_LOW_TOL * float(ref.abs().max()) if low
               else FLASH_F32_OUT_TOL)
        row = float((diff.amax(-1) / ref.abs().amax(-1).clamp_min(1e-30))
                    .max())
        rms = [rms_rel(o, ref)]
        lse_err = float((lse - cuda_attention.flash_attention_lse_reference(
            q, k, causal, scale)).abs().max())
        del ref, diff
        do = rand(o.shape, dtype)
        got = cuda_attention.flash_attention_backward(q, k, v, o, lse, do,
                                                      causal, scale)
        torch.cuda.synchronize()
        want = cuda_attention.flash_attention_backward_reference(
            q, k, v, o, lse, do, causal, scale)
        gerrs, gtols = [], []
        for g, w in zip(got, want):
            gerrs.append(float((g.float() - w.float()).abs().max()))
            gtols.append(FLASH_LOW_TOL * float(w.float().abs().max()) if low
                         else FLASH_F32_GRAD_TOL)
            rms.append(rms_rel(g, w))
        name = (f"{str(dtype)[6:]} causal={causal} (n,s,h,d)=({n},{s},{h},"
                f"{d}){' unaligned' if unaligned else ''}")
        errs["fwd"][name], errs["bwd"][name] = err, max(gerrs)
        print(f"flash kernel vs plain{label}: {name} forward max abs err "
              f"{err:.3g} (tol {tol:.3g}), worst row {row:.3g}, lse "
              f"{lse_err:.3g} (tol {FLASH_LSE_TOL}); backward "
              f"{max(gerrs):.3g} (tol {min(gtols):.3g}); RMS-relative O, "
              f"dq, dk, dv {', '.join(f'{r:.3g}' for r in rms)}")
        assert err <= tol, f"flash forward {name}: {err} > {tol}"
        assert lse_err <= FLASH_LSE_TOL, f"flash lse {name}: {lse_err}"
        assert all(e <= t for e, t in zip(gerrs, gtols)), \
            f"flash backward {name}: {gerrs} > {gtols}"
        if low:
            assert row <= FLASH_LOW_ROW_TOL, f"flash forward {name}: row {row}"
            assert max(rms) <= FLASH_LOW_RMS_TOL, f"flash {name}: RMS {rms}"

    sweep = {"fwd": {}, "bwd": {}}
    for dtype in (torch.float32, torch.bfloat16):
        for causal in (False, True):
            for s in (512, 200):
                for d in (64, 128):
                    check((2, s, 4, d), dtype, causal, sweep)
    # shapes TMA cannot address as they are: the wrapper pads the head
    # dim to a multiple of 8 and copies unaligned storage
    for causal in (False, True):
        check((2, 200, 4, 100), torch.bfloat16, causal, sweep)
        check((2, 200, 4, 64), torch.bfloat16, causal, sweep,
              unaligned=True)

    # capi/test_capi.c's transformer block through the C API (bf16,
    # causal, 2 heads of 8)
    check(CAPI_TEST_ATTENTION, torch.bfloat16, True, sweep,
          " (test_capi.c's block)")
    # the shape the main path gives the kernels: BERT-base at batch 16 in
    # bf16, not causal (build_transformer) and causal
    # (build_transformer_lm)
    n, s, h, d = BERT_BATCH, BERT["seq_len"], BERT["num_heads"], \
        BERT["d_model"] // BERT["num_heads"]
    main = {"fwd": {}, "bwd": {}}
    for causal in (False, True):
        check((n, s, h, d), torch.bfloat16, causal, main,
              " (main path's shape)")
    # no atomics: two backward calls on the same inputs, the same bits
    q, k, v, do = (rand((n, s, h, d), torch.bfloat16) for _ in range(4))
    o, lse = cuda_attention.flash_attention_forward(q, k, v, False,
                                                    d ** -0.5)
    a, b = (cuda_attention.flash_attention_backward(
        q, k, v, o, lse, do, False, d ** -0.5) for _ in range(2))
    assert all(torch.equal(x, y) for x, y in zip(a, b)), \
        "two flash backward calls differ"
    print(f"flash backward twice at {(n, s, h, d)} bf16: bit-equal")
    del q, k, v, do, o, lse, a, b
    torch.cuda.empty_cache()

    # timing at BERT-base's shapes, bf16, not causal (the encoder's call)
    # and causal (build_transformer_lm's); copies covering ~150 MB so the
    # loop finds L2 cold
    scale = d ** -0.5
    sets = []
    for _ in range(3):
        q, k, v = (rand((n, s, h, d), torch.bfloat16) for _ in range(3))
        sets.append([q, k, v, None, None, rand((n, s, h, d),
                                               torch.bfloat16)])
    # the library yardstick reads (n, h, s, d): the transposes are made
    # outside the timed calls
    lib_in = [tuple(t.transpose(1, 2).contiguous() for t in (q, k, v, do))
              for q, k, v, _, _, do in sets]
    timing = {"fwd": [], "bwd": []}

    def quoted(which, causal):
        return ("" if causal else
                f" (earlier design, mma.sync: "
                f"{FLASH_EARLIER_MS_QUOTED[which]} ms, quoted from PERF.md, "
                f"not measured in this run)")

    for causal in (False, True):
        for st in sets:
            st[3], st[4] = cuda_attention.flash_attention_forward(
                *st[:3], causal, scale)
        lib_sets = []
        for qt, kt, vt, dot in lib_in:
            qt, kt, vt = (t.requires_grad_(True) for t in (qt, kt, vt))
            out = F.scaled_dot_product_attention(qt, kt, vt, scale=scale,
                                                 is_causal=causal)
            lib_sets.append((qt, kt, vt, out, dot))
        fb_ms, fb_by, fb_bytes, fb_ops = flash_bounds(n, s, s, h, d, 2,
                                                      causal, False)
        bb_ms, bb_by, bb_bytes, bb_ops = flash_bounds(n, s, s, h, d, 2,
                                                      causal, True)
        fwd = {
            "shape": [n, s, h, d], "dtype": "bf16", "causal": causal,
            "design": FLASH_DESIGN,
            "kernel_ms": time_ms(
                lambda t: cuda_attention.flash_attention_forward(
                    t[0], t[1], t[2], causal, scale), sets, 50),
            "host_us": host_us(
                lambda t: cuda_attention.flash_attention_forward(
                    t[0], t[1], t[2], causal, scale), sets, 50),
            "plain_ms": time_ms(
                lambda t: cuda_attention.flash_attention_reference(
                    t[0], t[1], t[2], causal, scale), sets, 5),
            "library_ms": time_ms(lambda t: F.scaled_dot_product_attention(
                t[0].detach(), t[1].detach(), t[2].detach(), scale=scale,
                is_causal=causal), lib_sets, 50),
            "bound_ms": fb_ms, "bound_by": fb_by, "bytes": fb_bytes,
            "ops": fb_ops,
        }
        print("flash forward timing: " + json.dumps(fwd) + quoted("fwd",
                                                                   causal))
        bwd = {
            "shape": [n, s, h, d], "dtype": "bf16", "causal": causal,
            "design": FLASH_DESIGN,
            "kernel_ms": time_ms(
                lambda t: cuda_attention.flash_attention_backward(
                    *t, causal, scale), sets, 20),
            "host_us": host_us(
                lambda t: cuda_attention.flash_attention_backward(
                    *t, causal, scale), sets, 20),
            "plain_ms": time_ms(
                lambda t: cuda_attention.flash_attention_backward_reference(
                    *t, causal, scale), sets, 3),
            "library_ms": time_ms(lambda t: torch.autograd.grad(
                t[3], (t[0], t[1], t[2]), t[4], retain_graph=True),
                lib_sets, 20),
            "bound_ms": bb_ms, "bound_by": bb_by, "bytes": bb_bytes,
            "ops": bb_ops,
        }
        print("flash backward timing: " + json.dumps(bwd) + quoted("bwd",
                                                                    causal))
        timing["fwd"].append(fwd)
        timing["bwd"].append(bwd)
        if not causal:
            kernel_breakdown(lambda: cuda_attention.flash_attention_backward(
                *sets[0], False, scale), 20, card, what="flash backward")
        del lib_sets
    torch.cuda.synchronize()
    # the kernels line reports the error at the main path's shape and the
    # not-causal time (the encoder's call); the sweep's largest error (f32
    # and bf16 mixed) and the causal row ride beside them
    return {w: {"max_abs_err": max(main[w].values()),
                "sweep_max_abs_err": max(sweep[w].values()),
                "timing": timing[w][0], "shapes": timing[w]}
            for w in ("fwd", "bwd")}


def ln_check(cuda_norm, x, res, scale, bias, label: str) -> float:
    """The LayerNorm kernel at ``x`` in both output forms: the float32
    form within the ulp limits of the plain version and of the float64
    function, the narrow form (x's bf16/f16) equal to it cast, bit for
    bit.  Returns the float32 form's max abs error against the plain
    version."""
    import torch
    y = cuda_norm.fused_layernorm(x, res, scale, bias, 1e-5)
    narrow = cuda_norm.fused_layernorm(x, res, scale, bias, 1e-5, x.dtype)
    torch.cuda.synchronize()
    ref = cuda_norm.fused_layernorm_reference(x, res, scale, bias, 1e-5)
    exact = cuda_norm.layernorm_float64(x, res, scale, bias, 1e-5)
    u_plain = cuda_norm.ulp_distance(y, ref)
    u_exact = cuda_norm.ulp_distance(y, exact)
    u_ref = cuda_norm.ulp_distance(ref, exact)
    d = x.shape[-1]
    aligned = not (x.data_ptr() % 16 or (res is not None
                                         and res.data_ptr() % 16))
    plan = cuda_norm.launch_plan(x.numel() // d, d, x.element_size(), 4,
                                 aligned)
    name = (f"{str(x.dtype)[6:]} res={res is not None} {tuple(x.shape)}"
            f"{label}")
    assert u_exact <= LN_MAX_ULPS_EXACT and u_plain <= LN_MAX_ULPS_PLAIN, \
        (name, u_exact, u_plain)
    assert_bit_equal(narrow, y.to(x.dtype), f"layernorm {name} narrow out")
    err = float((y - ref).abs().max())
    print(f"layernorm kernel vs plain: {name} max abs err {err:.3g}, "
          f"{u_plain:g} ulp (tol {LN_MAX_ULPS_PLAIN}); vs float64 "
          f"{u_exact:g} ulp (tol {LN_MAX_ULPS_EXACT}), plain vs float64 "
          f"{u_ref:g} ulp; {str(x.dtype)[6:]} out == float32 out cast "
          f"(bit-equal); plan {json.dumps(plan._asdict())}")
    return err


def ln_timing_rows(cuda_norm, x, scale, bias, **extra) -> list:
    """The LayerNorm kernel at ``x``'s shape in each output form (float32,
    and x's own dtype when it is narrower): device ms beside the byte
    bound of that form, the launch floor (an empty kernel on the same
    grid), ``F.layer_norm`` (weights and output in x's dtype; the library
    yardstick, never called by the port) and the plain version, and the
    host's µs per call for the wrapper and the library call."""
    import torch
    import torch.nn.functional as F

    d = x.shape[-1]
    rows = x.numel() // d
    xs = rotation(x)
    lib_w = (scale.to(x.dtype), bias.to(x.dtype))

    def library(t):
        return F.layer_norm(t, (d,), *lib_w, 1e-5)

    common = {
        "library_ms": time_ms(library, xs, 200),
        "library_host_us": host_us(library, xs, 200),
    }
    out = []
    for out_dtype in dict.fromkeys((torch.float32, x.dtype)):
        def kernel(t, o=out_dtype):
            return cuda_norm.fused_layernorm(t, None, scale, bias, 1e-5, o)

        def plain(t, o=out_dtype):
            return cuda_norm.fused_layernorm_reference(t, None, scale, bias,
                                                       1e-5, o)

        out_b = torch.empty((), dtype=out_dtype).element_size()
        moved = rows * d * (x.element_size() + out_b) + 2 * d * 4
        row = {
            "shape": list(x.shape),
            "dtype": f"{str(x.dtype)[6:]} in, {str(out_dtype)[6:]} out",
            **extra, "design": LN_DESIGN,
            "kernel_ms": time_ms(kernel, xs, 200),
            "plain_ms": time_ms(plain, xs, 20 if rows > 1024 else 50),
            "floor_ms": time_ms(
                lambda t, o=out_dtype: cuda_norm.empty_launch(t, o), xs,
                200),
            **common,
            "host_us": host_us(kernel, xs, 200),
            "bound_ms": moved / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "bytes": moved,
            "plan": cuda_norm.launch_plan(
                rows, d, x.element_size(), out_b, True)._asdict(),
        }
        quote = ""
        if (x.dtype == torch.bfloat16 and out_dtype == torch.float32
                and rows in LN_EARLIER_MS_QUOTED):
            quote = (f" (earlier design: {LN_EARLIER_MS_QUOTED[rows]} ms, "
                     f"quoted from PERF.md, not measured in this run)")
        print(f"layernorm timing{quote}: " + json.dumps(row))
        out.append(row)
    del xs
    return out


def ln_sweep_plans(cuda_norm, nvec: int, vec: int):
    """(threads a row, rows a block, vectors a thread) of the plan sweep:
    a warp to 8 warps a row, 1, 2, 4 rows or 256 threads a block, and
    both the fewest vectors a thread the kernel is compiled for and the
    least power of two that hold a thread's share."""
    for tpr in (32, 64, 128, 256):
        per = -(-nvec // tpr)
        nvs = {min(n for n in cuda_norm.NV_CHOICES if n >= per),
               1 << (per - 1).bit_length()}
        for rpb in sorted({1, 2, 4, 256 // tpr} - {0}):
            if tpr * rpb <= 256:
                for nv in sorted(nvs):
                    if nv * vec <= cuda_norm.MAX_VALUES:
                        yield tpr, rpb, nv


def ln_plan_sweep(cuda_norm, gen, card) -> list:
    """The LayerNorm kernel's device time at the main path's row counts
    (16, 256 and 8192 rows of 768 bf16 in, and 8192 rows of 768 float32
    in, the float32 BERT session's form; each output form) under each
    plan of ``ln_sweep_plans``, each plan's output held to the ulp
    limits: the measurement behind the plan's rule.  ``launch_plan``'s
    own choice is marked, and its time over the sweep's best is printed
    per form."""
    import torch

    dev = gen.device
    d = BERT["d_model"]
    real = cuda_norm.launch_plan
    bert_rows = BERT_BATCH * BERT["seq_len"]
    out = []
    try:
        for rows, dtype in ((GEN_SLOTS, torch.bfloat16),
                            (GEN_CHUNK, torch.bfloat16),
                            (bert_rows, torch.bfloat16),
                            (bert_rows, torch.float32)):
            x = (3 * torch.randn((rows, d), generator=gen, device=dev)
                 + 1).to(dtype)
            scale = torch.randn(d, generator=gen, device=dev)
            bias = torch.randn(d, generator=gen, device=dev)
            ref = cuda_norm.fused_layernorm_reference(x, None, scale, bias,
                                                      1e-5)
            xs = rotation(x)
            vec = 16 // x.element_size()
            forms = list(dict.fromkeys((torch.float32, dtype)))
            chosen = {o: real(rows, d, x.element_size(),
                              torch.empty((), dtype=o).element_size(), True)
                      for o in forms}
            for tpr, rpb, nv in ln_sweep_plans(cuda_norm, d // vec, vec):
                plan = cuda_norm.LaunchPlan(vec, nv, tpr, rpb,
                                            -(-rows // rpb))
                cuda_norm.launch_plan = lambda *a, p=plan: p
                y = cuda_norm.fused_layernorm(x, None, scale, bias, 1e-5)
                torch.cuda.synchronize()
                assert cuda_norm.ulp_distance(y, ref) <= \
                    LN_MAX_ULPS_PLAIN, plan
                row = {"rows": rows, "in": str(dtype)[6:], "tpr": tpr,
                       "rpb": rpb, "nv": nv}
                for o in forms:
                    name = f"{str(o)[6:]}_out"
                    row[f"{name}_ms"] = time_ms(
                        lambda t, o=o: cuda_norm.fused_layernorm(
                            t, None, scale, bias, 1e-5, o), xs, 200)
                    row[f"{name}_chosen"] = plan == chosen[o]
                out.append(row)
            del xs
    finally:
        cuda_norm.launch_plan = real
    print(f"layernorm plan sweep (d {d}, 16-byte vectors) [{card}]: "
          + json.dumps(out))
    for rows, dtype in dict.fromkeys((r["rows"], r["in"]) for r in out):
        rs = [r for r in out if r["rows"] == rows and r["in"] == dtype]
        for key in [k[:-3] for k in rs[0] if k.endswith("_out_ms")]:
            best = min(rs, key=lambda r: r[f"{key}_ms"])
            mine = next((r for r in rs if r[f"{key}_chosen"]), None)
            if mine is None:
                print(f"layernorm plan at {rows} rows, {dtype} in, {key}: "
                      f"the chosen plan is not among the sweep's")
                continue
            print(f"layernorm plan at {rows} rows, {dtype} in, {key}: "
                  f"chosen tpr {mine['tpr']} rpb {mine['rpb']} nv "
                  f"{mine['nv']} {mine[f'{key}_ms']:.5f} ms, best tpr "
                  f"{best['tpr']} rpb {best['rpb']} nv {best['nv']} "
                  f"{best[f'{key}_ms']:.5f} ms (chosen / best "
                  f"{mine[f'{key}_ms'] / best[f'{key}_ms']:.3f})")
    return out


def layernorm_phase(cuda_norm, gen) -> dict:
    """The LayerNorm kernel against its plain version and the float64
    function in both output forms (f32 and bf16, residual or not, d 768
    and an odd d, and views one element into their storage), then timed
    at BERT-base's shape (16 x 512 rows of 768: bf16 in, f32 and bf16
    out; float32 in and out)."""
    import torch

    dev = gen.device
    max_err = 0.0

    def case(rows, d, dtype, with_res):
        x = (3 * torch.randn((rows, d), generator=gen, device=dev)
             + 1).to(dtype)
        res = (torch.randn((rows, d), generator=gen, device=dev).to(dtype)
               if with_res else None)
        return (x, res, torch.randn(d, generator=gen, device=dev),
                torch.randn(d, generator=gen, device=dev))

    for dtype in (torch.float32, torch.bfloat16):
        for with_res in (False, True):
            for rows, d in ((BERT_BATCH * BERT["seq_len"], BERT["d_model"]),
                            (1000, 777)):
                max_err = max(max_err, ln_check(
                    cuda_norm, *case(rows, d, dtype, with_res), ""))
            # a contiguous view one element into its storage: no 16-byte
            # vector lines up, so the kernel takes single elements
            x, res, scale, bias = case(GEN_SLOTS, BERT["d_model"], dtype,
                                       with_res)
            buf = torch.empty(x.numel() + 1, dtype=dtype, device=dev)
            view = buf[1:].view(x.shape)
            view.copy_(x)
            assert view.data_ptr() % 16
            max_err = max(max_err, ln_check(cuda_norm, view, res, scale,
                                            bias, " at storage offset 1"))

    rows, d = BERT_BATCH * BERT["seq_len"], BERT["d_model"]
    rows_t = []
    for dtype in (torch.bfloat16, torch.float32):
        rows_t += ln_timing_rows(
            cuda_norm, torch.randn((rows, d), generator=gen,
                                   device=dev).to(dtype),
            torch.randn(d, generator=gen, device=dev),
            torch.randn(d, generator=gen, device=dev), path="bert")
    torch.cuda.synchronize()
    # the entry's headline is the form earlier runs reported (bf16 in,
    # float32 out); the main path's form (a bf16 op stores bf16) beside it
    narrow = rows_t[1]
    return {"max_abs_err": max_err, "timing": rows_t[0], "shapes": rows_t,
            "headline_extra": {"ms_bf16_out": narrow["kernel_ms"],
                               "plain_ms_bf16_out": narrow["plain_ms"],
                               "bound_ms_bf16_out": narrow["bound_ms"]}}


def reset_counts(*fns) -> None:
    for fn in fns:
        fn.launches = 0
        if hasattr(fn, "launches_by_dtype"):
            fn.launches_by_dtype = {}


def transformer_serve_phase(ft, counters, card: str) -> dict:
    """Serve BERT-base in bf16 through ServingEngine; returns the kernels'
    launches during the serving run."""
    import numpy as np
    from flexflow_tpu_torch.models import build_transformer

    fwd_k, bwd_k, ln_k = counters
    cfg = ft.FFConfig(batch_size=BERT_BATCH, compute_dtype="bfloat16",
                      seed=SEED)
    model, _, _ = build_transformer(cfg, **BERT)   # on cuda
    model.compile()
    t0 = time.perf_counter()
    model.init_layers(seed=SEED)
    print(f"BERT-base: {model.num_parameters} parameters, init "
          f"{time.perf_counter() - t0:.3f}s")
    t0 = time.perf_counter()
    engine = ft.ServingEngine(model, max_batch=BERT_BATCH)
    print(f"engine warmup (buckets {engine.buckets}): "
          f"{time.perf_counter() - t0:.3f}s")

    rng = np.random.default_rng(SEED)
    seq, vocab = BERT["seq_len"], BERT["vocab_size"]
    sizes = [[1, 9, 16, 3, 12], [5, 16, 2, 7, 1]]
    reqs = [[rng.integers(0, vocab, (n, seq)).astype(np.int32) for n in ss]
            for ss in sizes]
    results = [[None] * len(ss) for ss in sizes]

    def producer(t: int) -> None:
        futs = [engine.submit(x) for x in reqs[t]]
        for i, f in enumerate(futs):
            results[t][i] = f.result(timeout=300)

    reset_counts(*counters)
    t0 = time.perf_counter()
    with engine:
        threads = [threading.Thread(target=producer, args=(t,))
                   for t in range(len(sizes))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
            assert not th.is_alive(), "producer thread did not finish"
        wall = time.perf_counter() - t0
        stats = engine.stats()
    launches = {"fwd": fwd_k.launches, "bwd": bwd_k.launches,
                "ln": ln_k.launches}
    n_req = sum(len(s) for s in sizes)
    rows = sum(sum(s) for s in sizes)
    assert stats["requests"] == n_req and stats["errors"] == 0, stats
    disp, layers = stats["dispatches"], BERT["num_layers"]
    assert disp > 0 and launches == {"fwd": layers * disp, "bwd": 0,
                                     "ln": 2 * layers * disp}, (launches,
                                                                stats)
    xs = np.concatenate([x for r in reqs for x in r])
    ys = np.concatenate([y for r in results for y in r])
    assert ys.shape == (rows, BERT["num_classes"]), ys.shape
    assert np.isfinite(ys).all(), "non-finite outputs"
    np.testing.assert_allclose(ys.sum(axis=1), 1.0, atol=1e-2)
    ref = model.predict(xs, batch_size=BERT_BATCH)
    err = float(np.abs(ys - ref).max())
    assert err <= 1e-2, f"engine vs predict max abs err {err}"
    print(f"transformer serve: {n_req} requests ({rows} rows of {seq} "
          f"tokens) from {len(sizes)} threads, {disp} dispatches, flash "
          f"forward launches {launches['fwd']} (= {layers} x dispatches), "
          f"layernorm launches {launches['ln']} (= {2 * layers} x "
          f"dispatches), flash "
          f"backward launches {launches['bwd']}, {rows / wall:.1f} rows/s, "
          f"p50 {stats['p50_ms']} ms, p99 {stats['p99_ms']} ms, engine vs "
          f"predict max abs err {err:.3g} [{card}]")
    xb = model._to_device((xs[:BERT_BATCH],))
    fwd = model.forward_compiled(BERT_BATCH)
    fwd_ms = time_ms(lambda t: fwd(model._params, t), [xb], 10,
                     spin_cycles=1_000_000_000)
    print(f"transformer forward at batch {BERT_BATCH} (bf16): "
          f"{fwd_ms:.4f} ms device time; engine dispatch (pack + forward "
          f"+ fetch) mean {stats['dispatch_ms']} ms wall [{card}]")
    kernel_breakdown(lambda: fwd(model._params, xb), 3, card)
    return launches


def transformer_train_phase(ft, counters, card: str) -> dict:
    """Train BERT-base in bf16 at batch 16 with Adam; returns the
    kernels' launches during the fit() run."""
    import numpy as np
    import torch
    from flexflow_tpu_torch.models import build_transformer

    fwd_k, bwd_k, ln_k = counters
    metrics = ["accuracy", "sparse_categorical_crossentropy"]
    cfg = ft.FFConfig(batch_size=BERT_BATCH, compute_dtype="bfloat16",
                      seed=SEED)
    model, _, logits = build_transformer(cfg, **BERT)
    model.compile(ft.AdamOptimizer(alpha=1e-4), metrics=metrics,
                  final_tensor=logits)
    model.init_layers(seed=SEED)
    n_batches = 4
    rng = np.random.default_rng(SEED)
    xs = rng.integers(0, BERT["vocab_size"],
                      (n_batches * BERT_BATCH, BERT["seq_len"])).astype(
        np.int32)
    y = rng.integers(0, BERT["num_classes"],
                     (n_batches * BERT_BATCH, 1)).astype(np.int32)

    record = EpochLosses()
    out = io.StringIO()
    reset_counts(*counters)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        model.fit(xs, y, epochs=1, callbacks=[record])
    fit_s = time.perf_counter() - t0
    launches = {"fwd": fwd_k.launches, "bwd": bwd_k.launches,
                "ln": ln_k.launches}
    print(out.getvalue(), end="")
    steps, layers = n_batches, BERT["num_layers"]
    assert model._step == steps, model._step
    assert launches == {"fwd": layers * steps, "bwd": layers * steps,
                        "ln": 2 * layers * steps}, launches
    fit_losses = record.epochs[0]
    assert fit_losses.shape == (steps,) and np.isfinite(fit_losses).all(), \
        fit_losses
    print(f"transformer fit: {steps} steps at batch {BERT_BATCH}, flash "
          f"launches {launches['fwd']} forward + {launches['bwd']} backward "
          f"(= {layers} + {layers} per step), layernorm launches "
          f"{launches['ln']} (= {2 * layers} per step), losses "
          f"{np.round(fit_losses, 4).tolist()}, "
          f"{fit_s:.3f}s wall [{card}]")

    # one batch, REPEAT_STEPS steps from a fresh start at the configured
    # alpha: the loss must fall (the last step's below the first's, the
    # last four's mean below the first four's).  From the random weights,
    # with no warmup, Adam's first steps move every parameter by alpha and
    # the loss jumps before it settles (PERF.md, PR 3), so the check
    # looks past the first eight steps
    model.compile(ft.AdamOptimizer(alpha=1e-4), metrics=metrics,
                  final_tensor=logits)
    model.init_layers(seed=SEED)
    xb = torch.from_numpy(xs[:BERT_BATCH]).to(model.device)
    yb = torch.from_numpy(y[:BERT_BATCH]).to(model.device)
    losses = torch.stack([model.train_batch(xb, yb)
                          for _ in range(REPEAT_STEPS)])
    losses = losses.cpu().numpy()
    assert np.isfinite(losses).all(), losses
    assert losses[-1] < losses[0] and losses[-4:].mean() < \
        losses[:4].mean(), f"loss did not fall: {losses}"
    print(f"transformer train_batch x{REPEAT_STEPS} on one batch (Adam "
          f"alpha 1e-4): loss {np.round(losses, 4).tolist()}")

    step_ms = time_ms(lambda b: model.train_batch(*b), [(xb, yb)], 5,
                      spin_cycles=3_000_000_000)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        model.train_batch(xb, yb)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / 5
    print(f"transformer training step at batch {BERT_BATCH} (bf16): "
          f"{step_ms:.4f} ms device time, {wall_ms:.4f} ms wall per step "
          f"over 5 steps [{card}]")
    kernel_breakdown(lambda: model.train_batch(xb, yb), 2, card,
                     what="training step")
    step_memory(model, (xb, yb), f"bert step (bf16, batch {BERT_BATCH}, "
                f"Adam)", card)
    return launches


def transformer_f32_step_check(ft, counters) -> None:
    """A small float32 Transformer training step on the card (kernels)
    against its CPU twin (plain versions): same seed, same weights."""
    import numpy as np
    from flexflow_tpu_torch.models import build_transformer

    fwd_k, bwd_k, ln_k = counters
    arch = dict(num_layers=2, d_model=128, num_heads=2, d_ff=256,
                seq_len=128, vocab_size=1000, num_classes=2)
    rng = np.random.default_rng(SEED)
    x = rng.integers(0, arch["vocab_size"], (2, arch["seq_len"])).astype(
        np.int32)
    y = rng.integers(0, 2, (2, 1)).astype(np.int32)
    results = []
    for device in ("cuda", "cpu"):
        cfg = ft.FFConfig(batch_size=2, compute_dtype="float32", seed=SEED)
        m, _, logits = build_transformer(cfg, device=device, **arch)
        m.compile(ft.SGDOptimizer(lr=0.01, momentum=0.9),
                  final_tensor=logits)
        m.init_layers(seed=SEED)
        reset_counts(*counters)
        loss = float(m.train_batch(x, y))
        if device == "cuda":
            assert (fwd_k.launches, bwd_k.launches, ln_k.launches) == (
                2, 2, 4), (fwd_k.launches, bwd_k.launches, ln_k.launches)
        results.append((loss, {p.name: m.get_weights(p.name)
                               for p in m.parameters}))
    (loss_c, w_c), (loss_h, w_h) = results
    loss_err = abs(loss_c - loss_h)
    param_err = max(float(np.abs(w_c[k] - w_h[k]).max()) for k in w_h)
    assert loss_err <= F32_STEP_TOL and param_err <= F32_STEP_TOL, (
        loss_err, param_err)
    print(f"f32 Transformer training step cuda (kernels) vs cpu (plain): "
          f"loss {loss_c:.6f} vs {loss_h:.6f} (abs err {loss_err:.3g}), max "
          f"abs err over the updated parameters {param_err:.3g} (tolerance "
          f"{F32_STEP_TOL})")


def build_zoo(ft, name: str, batch: int, device=None, **overrides):
    """A zoo model compiled with plain SGD (its embedding tables on the
    sparse update path unless ``sparse_embedding_updates`` is False);
    ``momentum`` and ``import_strategy_file`` may be overridden."""
    from flexflow_tpu_torch import models

    builder, kw, _, _, lr = ZOO[name]
    sparse = overrides.pop("sparse_embedding_updates", None)
    momentum = overrides.pop("momentum", 0.0)
    cfg = ft.FFConfig(batch_size=batch, compute_dtype=overrides.pop(
        "compute_dtype", "bfloat16"), seed=SEED,
        sparse_embedding_updates=sparse,
        import_strategy_file=overrides.pop("import_strategy_file", ""))
    model, _, _ = getattr(models, builder)(cfg, device=device,
                                           **{**kw, **overrides})
    last = model.layers[-1]
    if last.op_type == ft.OpType.MSELOSS:   # sets the loss and metric
        model.compile(ft.SGDOptimizer(lr=lr, momentum=momentum), metrics=[],
                      final_tensor=last.outputs[0])
    else:                                   # NMT: per-token sparse CE
        model.compile(ft.SGDOptimizer(lr=lr),
                      "sparse_categorical_crossentropy",
                      ["accuracy", "sparse_categorical_crossentropy"])
    model.init_layers(seed=SEED)
    return model


def zoo_batch(model, n: int, rng):
    """``n`` rows of inputs for ``model`` and their labels: ids drawn
    over the rows of the table each id input feeds, float features from
    a normal, next-token labels for a sequence model (its last input
    shifted) and targets in [0, 1) for a regression head."""
    import numpy as np
    from flexflow_tpu_torch.ops.linear import Embedding

    xs = []
    for t in model.input_tensors:
        shape = (n,) + tuple(t.shape[1:])
        if t.dtype == "int32":
            rows = next(op.num_entries for op in model.layers
                        if isinstance(op, Embedding)
                        and op.inputs[0].uid == t.uid)
            xs.append(rng.integers(0, rows, shape).astype(np.int32))
        else:
            xs.append(rng.standard_normal(shape).astype(np.float32))
    if model.label_tensor.dtype == "int32":
        return xs, np.roll(xs[-1], -1, axis=1)
    return xs, rng.random((n, 1)).astype(np.float32)


def zoo_serve(ft, name: str, model, card: str, label: str = "") -> None:
    """Serve ``model`` through ServingEngine: ZOO_CLIENTS closed-loop
    clients over ZOO_ROUNDS rounds of ZOO_REQUESTS requests, each
    round's rows/s and client-side latency p50/p99.  Every output's
    shape is checked; the first ZOO_CHECKED requests' rows are held
    against predict() (finite, and for NMT probabilities summing to 1).
    ``label`` names the model in the lines (default ``name``)."""
    import numpy as np

    max_batch = ZOO[name][3]
    name, kind = label or name, name
    t0 = time.perf_counter()
    engine = ft.ServingEngine(model, max_batch=max_batch)
    print(f"{name} engine warmup (buckets {engine.buckets}): "
          f"{time.perf_counter() - t0:.3f}s")
    rng = np.random.default_rng(SEED)
    out_shape = tuple(model._final_tensor.shape[1:])
    checked = []    # (inputs, outputs) of the first ZOO_CHECKED requests
    latencies, rates = [], []

    def client(reqs, lat, keep) -> None:
        for i, x in reqs:
            t = time.perf_counter()
            y = engine.submit(*x).result(timeout=300)
            lat.append(time.perf_counter() - t)
            assert y.shape == (x[0].shape[0],) + out_shape, y.shape
            if keep and i < ZOO_CHECKED:
                checked.append((i, x, y))

    # each round sends requests of the same sizes, in the same order
    sizes = np.minimum(np.exp(rng.uniform(
        0, np.log(max_batch + 1), ZOO_REQUESTS)).astype(int), max_batch)
    with engine:
        for r in range(ZOO_ROUNDS):
            xall, _ = zoo_batch(model, int(sizes.sum()), rng)
            if r == 0:
                x0 = xall
            cuts = np.cumsum(sizes)[:-1]
            reqs = list(enumerate(zip(*[np.split(a, cuts) for a in xall])))
            lats = [[] for _ in range(ZOO_CLIENTS)]
            before = engine.stats()["dispatches"]
            t0 = time.perf_counter()
            threads = [threading.Thread(
                target=client, args=(reqs[c::ZOO_CLIENTS], lats[c], r == 0))
                for c in range(ZOO_CLIENTS)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=600)
                assert not th.is_alive(), "client thread did not finish"
            wall = time.perf_counter() - t0
            stats = engine.stats()
            lat = np.array([v for c in lats for v in c]) * 1e3
            assert lat.size == ZOO_REQUESTS, lat.size
            latencies.append(lat)
            rates.append(sizes.sum() / wall)
            p50, p99 = np.percentile(lat, [50, 99])
            print(f"{name} serve round {r}: {ZOO_REQUESTS} requests "
                  f"({sizes.sum()} rows, 1-{sizes.max()} a request) from "
                  f"{ZOO_CLIENTS} closed-loop clients, "
                  f"{stats['dispatches'] - before} dispatches, "
                  f"{rates[-1]:.1f} rows/s, latency p50 {p50:.3f} ms, "
                  f"p99 {p99:.3f} ms [{card}]")
    assert stats["requests"] == ZOO_ROUNDS * ZOO_REQUESTS and \
        stats["errors"] == 0, stats
    checked.sort(key=lambda c: c[0])
    xs = [np.concatenate(c) for c in zip(*[x for _, x, _ in checked])]
    ys = np.concatenate([y for _, _, y in checked])
    assert np.isfinite(ys).all(), "non-finite outputs"
    if kind == "nmt":   # per-token probabilities over the vocabulary
        np.testing.assert_allclose(ys.sum(axis=-1), 1.0, atol=1e-2)
    ref = model.predict(xs, batch_size=max_batch)
    err = float(np.abs(ys - ref).max())
    assert err <= 1e-2, f"engine vs predict max abs err {err}"
    lat = np.concatenate(latencies)
    p50, p99 = np.percentile(lat, [50, 99])
    print(f"{name} serve: {lat.size} requests over {ZOO_ROUNDS} rounds, "
          f"output rows {out_shape} ({ys[0].nbytes} bytes each), rows/s "
          f"by round {[round(float(v), 1) for v in rates]}, latency p50 "
          f"{p50:.3f} ms, p99 {p99:.3f} ms; mean dispatch "
          f"{stats['dispatch_ms']} ms wall; engine vs predict max abs err "
          f"{err:.3g} over the first {len(checked)} requests "
          f"({ys.shape[0]} rows) [{card}]")
    xb = model._to_device(tuple(a[:max_batch] for a in x0))
    fwd = model.forward_compiled(max_batch)
    fwd_ms = time_ms(lambda t: fwd(model._params, t), [xb], 10,
                     spin_cycles=1_000_000_000)
    print(f"{name} forward at batch {max_batch} (bf16): {fwd_ms:.4f} ms "
          f"device time; engine dispatch (pack + forward + fetch) mean "
          f"{stats['dispatch_ms']} ms wall [{card}]")
    kernel_breakdown(lambda: fwd(model._params, xb), 3, card)


def time_step(model, batch, card: str, label: str) -> list:
    """A training step's device time (events behind a GPU spin) and wall
    time, then its device time by kernel; returns the kernel rows."""
    import torch

    step_ms = time_ms(lambda b: model.train_batch(*b), [batch], 5,
                      spin_cycles=3_000_000_000)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        model.train_batch(*batch)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / 5
    print(f"{label} training step at batch {batch[0].shape[0]}: "
          f"{step_ms:.4f} ms device time, {wall_ms:.4f} ms wall per step "
          f"over 5 steps [{card}]")
    return kernel_breakdown(lambda: model.train_batch(*batch), 2, card,
                            what="training step")


def zoo_train(ft, name: str, model, card: str, label: str = ""):
    """fit() over a few batches, then ZOO_REPEAT_STEPS train_batch steps
    on one batch (the loss must fall), then a timed, profiled step and
    the step's peak memory.  Returns the device batch."""
    import numpy as np
    import torch

    batch = ZOO[name][2]
    lr = ZOO[name][4]
    name = label or name
    rng = np.random.default_rng(SEED + 1)
    xs, y = zoo_batch(model, ZOO_FIT_BATCHES * batch, rng)
    record = EpochLosses()
    out = io.StringIO()
    step0 = model._step
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        model.fit(xs, y, epochs=1, callbacks=[record])
    fit_s = time.perf_counter() - t0
    text = out.getvalue()
    print(text, end="")
    assert model._step == step0 + ZOO_FIT_BATCHES, model._step
    assert "epoch 0: " in text and "THROUGHPUT = " in text, text
    fit_losses = record.epochs[0]
    assert np.isfinite(fit_losses).all(), fit_losses
    print(f"{name} fit: {ZOO_FIT_BATCHES} steps at batch {batch}, losses "
          f"{[round(float(v), 6) for v in fit_losses]}, {fit_s:.3f}s wall "
          f"[{card}]")

    xb = model._to_device(tuple(a[:batch] for a in xs) + (y[:batch],))
    losses = torch.stack([model.train_batch(*xb)
                          for _ in range(ZOO_REPEAT_STEPS)]).cpu().numpy()
    assert np.isfinite(losses).all(), losses
    # the mean of the last three steps, not one value: NMT's loss at lr
    # 0.01 falls about 2.5e-6 a step, a few float32 ulps of its 9.9
    tail = float(losses[-3:].astype(np.float64).mean())
    assert tail < losses[0], f"loss did not fall: {losses}"
    print(f"{name} train_batch x{ZOO_REPEAT_STEPS} on one batch (SGD lr "
          f"{lr}): loss {losses[0]:.7f} -> mean of the last 3 "
          f"{tail:.7f} ({losses.tolist()})")
    rows = time_step(model, xb, card, f"{name} (bf16)")
    if rows:
        total = sum(t for _, t in rows)
        gemm = sum(t for k, t in rows if "gemm" in k.lower())
        print(f"{name} step: kernels named gemm (the float32 products of "
              f"the cast operands) {100 * gemm / total:.1f}% of device "
              f"busy time [{card}]")
    step_memory(model, xb, f"{name} step (bf16, batch {batch})", card)
    return xb


def dlrm_sparse_checks(ft, model, xb, card: str) -> None:
    """DLRM's sparse path on the card: the tables leave the optimizer's
    dict; 3 sparse steps against 3 dense steps from the same weights;
    the time of each step; a batch with ids -1 and rows + 3."""
    import numpy as np
    import torch

    batch = ZOO["dlrm"][2]
    tables = [tname for _, tname, _ in model._sparse_specs]
    assert len(tables) == 4, model._sparse_specs
    _, _, grads, _, row_grads = model._loss_and_grads(xb, model._step,
                                                      sparse=True)
    assert not set(tables) & set(grads) and len(row_grads) == 4
    del grads, row_grads
    print(f"dlrm sparse path: {len(tables)} tables, absent from the "
          f"optimizer's dict; their row gradients "
          f"({batch}, {DLRM['embedding_bag_size']}, "
          f"{DLRM['sparse_feature_size']}) each")

    rng = np.random.default_rng(SEED + 2)
    models = {}
    for sparse in (None, False):
        m = build_zoo(ft, "dlrm", batch, sparse_embedding_updates=sparse)
        models[sparse] = m
    ms, md = models[None], models[False]
    assert len(ms._sparse_specs) == 4 and not md._sparse_specs
    w0 = {k: v.clone() for k, v in ms._params.items() if k in tables}
    batches = []
    for _ in range(3):
        xs, y = zoo_batch(ms, batch, rng)
        batches.append(ms._to_device(xs + [y]))
    ls = torch.stack([ms.train_batch(*b) for b in batches]).cpu().numpy()
    ld = torch.stack([md.train_batch(*b) for b in batches]).cpu().numpy()
    loss_err = float(np.abs(ls - ld).max() / np.abs(ld).max())
    assert loss_err <= 1e-5, (ls, ld)
    param_err = max(float((ms._params[k] - md._params[k]).abs().max())
                    for k in md._params)
    assert param_err <= SPARSE_DENSE_TOL, param_err
    moved = kept = 0
    for i, t in enumerate(tables):
        ids = torch.unique(torch.cat([b[i].reshape(-1) for b in batches]))
        touched = torch.zeros(DLRM["embedding_size"][i], dtype=torch.bool,
                              device=ms.device)
        touched[ids.long()] = True
        assert torch.equal(bits(ms._params[t][~touched]),
                           bits(w0[t][~touched])), t
        assert torch.equal(bits(md._params[t][~touched]),
                           bits(w0[t][~touched])), t
        moved += int((ms._params[t][touched] != w0[t][touched]).any(1).sum())
        kept += int((~touched).sum())
    print(f"dlrm 3 sparse steps vs 3 dense steps (bf16, same weights): "
          f"losses {ls.tolist()} vs {ld.tolist()} (relative err "
          f"{loss_err:.3g}), max abs err over every parameter "
          f"{param_err:.3g} (tolerance {SPARSE_DENSE_TOL}); {moved} "
          f"touched rows moved, {kept} untouched rows bit-unchanged on "
          f"both paths [{card}]")
    del w0
    for sparse, label in ((None, "sparse"), (False, "dense")):
        time_step(models[sparse], batches[0], card, f"dlrm {label} (bf16)")

    # ids -1 (wraps to the last row) and rows + 3 (a NaN row, its
    # gradient dropped) in table 0, on both paths
    rows0 = DLRM["embedding_size"][0]
    bad = [b.clone() for b in batches[0]]
    bad[0][0, 0], bad[0][1, 0] = -1, rows0 + 3
    wrapped = [b.clone() for b in bad]
    wrapped[0][0, 0] = rows0 - 1
    fwd = ms.forward_compiled(batch)
    p_bad = fwd(ms._params, bad[:-1]).float()
    p_wrap = fwd(ms._params, wrapped[:-1]).float()
    assert torch.isnan(p_bad[1]).all() and torch.isfinite(p_bad[0]).all()
    assert torch.isnan(p_bad).sum() == p_bad.shape[1]
    assert torch.equal(p_bad[0], p_wrap[0])
    last0 = {s: m._params[tables[0]][rows0 - 1].clone()
             for s, m in models.items()}
    out = {}
    for sparse, m in models.items():
        loss = float(m.train_batch(*bad))
        torch.cuda.synchronize()
        assert np.isnan(loss), loss
        assert all(torch.isfinite(m._params[t]).all() for t in tables)
        assert not torch.equal(m._params[tables[0]][rows0 - 1],
                               last0[sparse])
        out[sparse] = {k: v for k, v in m._params.items()}
    nan_params = sorted(k for k, v in out[None].items()
                        if torch.isnan(v).any())
    for k in out[False]:
        a, b = out[None][k], out[False][k]
        assert torch.equal(torch.isnan(a), torch.isnan(b)), k
        d = (a - b).abs()[~torch.isnan(a)]
        assert d.numel() == 0 or float(d.max()) <= SPARSE_DENSE_TOL, k
    print(f"dlrm batch with ids -1 and {rows0 + 3} in {tables[0]}: the row "
          f"of id {rows0 + 3} predicts NaN, the row of -1 predicts as id "
          f"{rows0 - 1} (bit-equal); one step on each path: loss NaN, no "
          f"device assert, every table finite, row {rows0 - 1} moved, the "
          f"same NaN parameters on both paths ({nan_params}) [{card}]")


def zoo_phase(ft, name: str, card: str, counters) -> None:
    """Serve and train one zoo model at full width in bf16 (random
    weights from SEED).  None of the repo's TPU kernels is on its path:
    their counts stay 0."""
    import torch

    reset_counts(*counters)
    batch = ZOO[name][2]
    t0 = time.perf_counter()
    model = build_zoo(ft, name, batch)   # on cuda
    print(f"{name}: {model.num_parameters} parameters, {len(model.layers)} "
          f"ops, sparse embedding tables {len(model._sparse_specs)}, built "
          f"and initialised in {time.perf_counter() - t0:.3f}s")
    zoo_serve(ft, name, model, card)
    xb = zoo_train(ft, name, model, card)
    if name == "dlrm":
        dlrm_sparse_checks(ft, model, xb, card)
    launches = [fn.launches for fn in counters]
    assert launches == [0] * len(counters), launches
    del model, xb
    torch.cuda.empty_cache()


def zoo_f32_step_checks(ft) -> None:
    """Small float32 versions of the zoo: 3 SGD steps on the card against
    their CPU twins (same seed, same weights and batches); DLRM also with
    ids -1 and rows + 3, whose NaN parameters must match."""
    import numpy as np

    for name, kw in ZOO_SMALL.items():
        runs = []
        for device in ("cuda", "cpu"):
            m = build_zoo(ft, name, 16, device=device,
                          compute_dtype="float32", **kw)
            rng = np.random.default_rng(SEED)
            batches = [zoo_batch(m, 16, rng) for _ in range(3)]
            if name == "dlrm":
                bad = [a.copy() for a in batches[2][0]]
                bad[0][0, 0] = -1
                bad[0][1, 0] = kw["embedding_size"][0] + 3
                batches.append((bad, batches[2][1]))
            losses = [float(m.train_batch(*x, y)) for x, y in batches]
            runs.append((np.array(losses), {p.name: m.get_weights(p.name)
                                            for p in m.parameters}))
        (l_c, w_c), (l_h, w_h) = runs
        assert np.array_equal(np.isnan(l_c), np.isnan(l_h)), (l_c, l_h)
        ok = ~np.isnan(l_h)
        loss_err = float(np.abs(l_c[ok] - l_h[ok]).max())
        param_err = 0.0
        for k in w_h:
            nan = np.isnan(w_h[k])
            assert np.array_equal(np.isnan(w_c[k]), nan), k
            if (~nan).any():
                param_err = max(param_err, float(
                    np.abs(w_c[k][~nan] - w_h[k][~nan]).max()))
        assert loss_err <= F32_STEP_TOL and param_err <= F32_STEP_TOL, (
            name, loss_err, param_err)
        extra = (", then a step with ids -1 and rows + 3: NaN in the same "
                 f"{sum(np.isnan(v).any() for v in w_h.values())} "
                 f"parameters" if name == "dlrm" else "")
        print(f"f32 {name} 3 SGD steps cuda vs cpu: losses "
              f"{np.round(l_c, 6).tolist()}, max abs err {loss_err:.3g}, "
              f"max abs err over the parameters {param_err:.3g} (tolerance "
              f"{F32_STEP_TOL}){extra}")


def host_state(model) -> dict:
    """Owned host copies of the parameters and the optimizer state's
    leaves (``opt:<i>``, the checkpoint's names), for bit comparisons."""
    from flexflow_tpu_torch.model import (_flatten_state, _leaf_to_host,
                                          to_host)
    out = {k: to_host(v).copy() for k, v in model._params.items()}
    for i, leaf in enumerate(_flatten_state(model._opt_state)):
        out[f"opt:{i}"] = _leaf_to_host(leaf)
    return out


def max_diff(a: dict, b: dict, keys=None) -> float:
    """Largest absolute difference over the arrays of two ``host_state``
    dicts (those named in ``keys``, default all): 0.0 when every one has
    the same bits."""
    import numpy as np
    worst = 0.0
    for k in (a if keys is None else keys):
        v = a[k]
        if not np.array_equal(v.view(np.uint8), b[k].view(np.uint8)):
            worst = max(worst, float(np.abs(v.astype(np.float64)
                                            - b[k]).max()) or 1e-300)
    return worst


def remat_reckoning(model, op_type) -> int:
    """Forward launches of ``op_type``'s kernel in one remat step: two
    for an op in a checkpointed segment (the forward, then the
    recomputation in the backward), one in the last segment."""
    segs = model.remat_segments()
    return sum((1 if i == len(segs) - 1 else 2)
               * sum(op.op_type == op_type for op in seg)
               for i, seg in enumerate(segs))


def restore(model, start) -> None:
    """Put back (params, optimizer state, step) taken before a step; the
    optimizers are functional, so the saved references are unchanged."""
    model._params, model._opt_state, model._step = (dict(start[0]),
                                                    start[1], start[2])


def bert_batch(model, rows: int = BERT_BATCH):
    import numpy as np
    import torch
    rng = np.random.default_rng(SEED + 8)
    x = rng.integers(0, BERT["vocab_size"], (rows, BERT["seq_len"]))
    y = rng.integers(0, BERT["num_classes"], (rows, 1))
    return (torch.from_numpy(x.astype(np.int32)).to(model.device),
            torch.from_numpy(y.astype(np.int32)).to(model.device))


def bert_remat_phase(ft, counters, card: str) -> dict:
    """BERT-base (bf16, batch 16) under segmented remat: one step from
    one state with remat off and on (loss and parameters compared, the
    step's peak memory must fall), the kernels' launches against the
    segment reckoning, and a step's device time each way.  Returns the
    remat step's launches."""
    import numpy as np
    import torch
    from flexflow_tpu_torch.model import to_host
    from flexflow_tpu_torch.models import build_transformer

    fwd_k, bwd_k, ln_k = counters
    free_garbage()
    cfg = ft.FFConfig(batch_size=BERT_BATCH, compute_dtype="bfloat16",
                      seed=SEED)
    model, _, logits = build_transformer(cfg, **BERT)
    model.compile(ft.SGDOptimizer(lr=REMAT_LR, momentum=0.9),
                  final_tensor=logits)
    model.init_layers(seed=SEED)
    xb, yb = bert_batch(model)
    start = (dict(model._params), model._opt_state, model._step)
    runs = {}
    for remat in (False, True):
        restore(model, start)
        model.config.remat = remat
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        reset_counts(*counters)
        loss = model.train_batch(xb, yb)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        launches = {"fwd": fwd_k.launches, "bwd": bwd_k.launches,
                    "ln": ln_k.launches}
        runs[remat] = (float(loss), host_state(model), peak, held, launches)
    (l0, s0, pk0, h0, n0), (l1, s1, pk1, h1, n1) = runs[False], runs[True]
    layers = BERT["num_layers"]
    segs = model.remat_segments()
    want = {"fwd": remat_reckoning(model, ft.OpType.ATTENTION),
            "bwd": layers, "ln": remat_reckoning(model, ft.OpType.LAYERNORM)}
    assert n0 == {"fwd": layers, "bwd": layers, "ln": 2 * layers}, n0
    assert n1 == want and want["fwd"] > layers, (n1, want)
    # the parameters: SGD's momentum after one step is the gradient, not
    # the update the tolerance is scaled by
    diff = max_diff(s1, s0, start[0])
    update = max(float(np.abs(s0[k] - to_host(v)).max())
                 for k, v in start[0].items())
    loss_rel = abs(l1 - l0) / max(abs(l0), 1e-30)
    print(f"bert remat: {len(model.layers)} layers in {len(segs)} segments "
          f"({[len(sg) for sg in segs]}), loss {l0:.6f} without remat, "
          f"{l1:.6f} with (rel diff {loss_rel:.3g}), largest parameter "
          f"difference {diff:.3g} ({'bit-equal' if diff == 0 else 'not bit-equal'}"
          f"; the step's largest update {update:.3g}) [{card}]")
    assert l1 == l0 and diff == 0, (loss_rel, diff, update)
    assert pk1 < pk0, (pk0, pk1)
    record_memory(model, pk0, f"bert step (bf16, batch {BERT_BATCH}, SGD "
                  f"momentum)", card)
    record_memory(model, pk1, f"bert remat step (bf16, batch {BERT_BATCH})",
                  card)
    print(f"bert remat memory: peak over a step {pk0 / 2**30:.3f} GiB "
          f"without remat, {pk1 / 2**30:.3f} GiB with ({(pk0 - h0) / 2**30:.3f}"
          f" and {(pk1 - h1) / 2**30:.3f} GiB above the {h0 / 2**30:.3f} GiB "
          f"held before it) [{card}]")
    print(f"bert remat launches a step: flash forward {n1['fwd']} (= the "
          f"segments' reckoning {want['fwd']}: {layers} without remat), "
          f"flash backward {n1['bwd']}, layernorm {n1['ln']} (= "
          f"{want['ln']}: {2 * layers} without remat)")
    for remat in (False, True):
        model.config.remat = remat
        ms = time_ms(lambda b: model.train_batch(*b), [(xb, yb)], 5,
                     spin_cycles=3_000_000_000)
        print(f"bert {'remat' if remat else 'plain'} training step at batch "
              f"{BERT_BATCH} (bf16): {ms:.4f} ms device time [{card}]")
    model.config.remat = False
    return n1


def bert_accumulate_phase(ft, counters, card: str) -> dict:
    """BERT-base in float32 (batch 16, SGD with momentum): the step with
    gradient accumulation 2, without and with remat, against the
    full-batch step from the same state; peak memory of each.  Returns
    the kernels' launches of the two accumulated steps."""
    import torch
    from flexflow_tpu_torch.models import build_transformer

    fwd_k, bwd_k, ln_k = counters
    free_garbage()
    cfg = ft.FFConfig(batch_size=BERT_BATCH, compute_dtype="float32",
                      seed=SEED)
    model, _, logits = build_transformer(cfg, **BERT)
    model.compile(ft.SGDOptimizer(lr=ACCUM_LR, momentum=0.9),
                  final_tensor=logits)
    model.init_layers(seed=SEED)
    xb, yb = bert_batch(model)
    start = (dict(model._params), model._opt_state, model._step)
    layers = BERT["num_layers"]
    runs, total = {}, {"fwd": 0, "bwd": 0, "ln": 0}
    for accum, remat in ((1, False), (KNOBS_ACCUM, False),
                         (KNOBS_ACCUM, True)):
        restore(model, start)
        model.config.gradient_accumulation_steps = accum
        model.config.remat = remat
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts(*counters)
        loss = float(model.train_batch(xb, yb))
        peak = torch.cuda.max_memory_allocated()
        got = {"fwd": fwd_k.launches, "bwd": bwd_k.launches,
               "ln": ln_k.launches}
        if remat:
            want = {"fwd": accum * remat_reckoning(model,
                                                   ft.OpType.ATTENTION),
                    "bwd": accum * layers,
                    "ln": accum * remat_reckoning(model,
                                                  ft.OpType.LAYERNORM)}
        else:
            want = {"fwd": accum * layers, "bwd": accum * layers,
                    "ln": 2 * accum * layers}
        assert got == want, (accum, remat, got, want)
        if accum > 1:
            total = {k: total[k] + got[k] for k in total}
        runs[(accum, remat)] = (loss, host_state(model), peak)
        record_memory(model, peak, f"bert f32 step, accumulation {accum}"
                      f"{' + remat' if remat else ''}", card)
    model.config.gradient_accumulation_steps = 1
    model.config.remat = False
    l1, s1, p1 = runs[(1, False)]
    for remat in (False, True):
        lk, sk, pk = runs[(KNOBS_ACCUM, remat)]
        loss_err, param_err = abs(lk - l1), max_diff(sk, s1, start[0])
        print(f"bert f32 accumulation {KNOBS_ACCUM}"
              f"{' + remat' if remat else ''} vs the full batch: loss "
              f"{lk:.6f} vs {l1:.6f} (abs err {loss_err:.3g}), largest "
              f"parameter difference {param_err:.3g} (tolerance "
              f"{ACCUM_TOL}); peak memory {pk / 2**30:.3f} GiB against "
              f"{p1 / 2**30:.3f} GiB [{card}]")
        assert loss_err <= ACCUM_TOL and param_err <= ACCUM_TOL, (
            remat, loss_err, param_err)
    return total


def resnet_knobs_model(ft, **knobs):
    cfg = ft.FFConfig(batch_size=BATCH, compute_dtype="bfloat16", seed=SEED,
                      **knobs)
    model, _, _ = build_cnn(ft, "resnet50", cfg, batch_norm=True)
    model.compile(ft.SGDOptimizer(lr=KNOBS_LR, momentum=0.9),
                  metrics=["accuracy"])
    model.init_layers(seed=SEED)
    return model


@contextlib.contextmanager
def deterministic_cudnn():
    """cuDNN's deterministic algorithms (no atomics in the convolutions'
    weight gradients), for the bit comparisons of whole steps."""
    import torch
    old = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = old


def resnet50_knobs_phase(ft, cuda_pool, card: str) -> dict:
    """ResNet-50 with BatchNorm (bf16, batch 64) under gradient
    accumulation 2, windows of 4 and the padded tail: fit over 4 x 64 +
    17 samples (5 steps of 2 microbatches), the max-pool launches a step,
    every running statistic moved; then a train_window of 4 against 4
    train_batch calls from one state, bit for bit.  Returns fit's
    max-pool launches."""
    import numpy as np
    import torch

    _, image, classes, pools = CNNS["resnet50"]
    model = resnet_knobs_model(ft, gradient_accumulation_steps=KNOBS_ACCUM,
                               steps_per_dispatch=KNOBS_WINDOW,
                               pad_tail_batches=True)
    stats = [p.name for p in model.parameters if not p.trainable]
    assert len(stats) == 2 * 48, len(stats)
    init = {k: model._params[k].clone() for k in stats}
    xs, y = ft.synthetic_dataset(KNOBS_SAMPLES, [(3, image, image)], (1,),
                                 num_classes=classes, seed=SEED)
    steps = -(-KNOBS_SAMPLES // BATCH)
    record = EpochLosses()
    reset_counts(cuda_pool.max_pool_nhwc, cuda_pool.max_pool_nhwc_backward)
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        model.fit(xs, y, epochs=1, callbacks=[record])
    fit_s = time.perf_counter() - t0
    launches = {"fwd": cuda_pool.max_pool_nhwc.launches,
                "bwd": cuda_pool.max_pool_nhwc_backward.launches}
    print(out.getvalue(), end="")
    losses = record.epochs[0]
    assert model._step == steps and losses.shape == (steps,), losses
    assert np.isfinite(losses).all(), losses
    per_step = pools * KNOBS_ACCUM
    assert launches == {"fwd": per_step * steps,
                        "bwd": per_step * steps}, launches
    assert model.perf_metrics.train_all == KNOBS_SAMPLES
    unmoved = [k for k in stats if torch.equal(model._params[k], init[k])]
    assert not unmoved, f"running statistics did not move: {unmoved}"
    print(f"resnet50 knobs fit: {KNOBS_SAMPLES} samples in {steps} steps "
          f"(windows of {KNOBS_WINDOW}, accumulation {KNOBS_ACCUM}, the "
          f"last step the padded tail of {KNOBS_SAMPLES % BATCH}), losses "
          f"{np.round(losses, 4).tolist()}, max-pool launches "
          f"{launches['fwd']} forward + {launches['bwd']} backward (= "
          f"{per_step} + {per_step} a step), all {len(stats)} running "
          f"statistics moved, {fit_s:.3f}s wall [{card}]")

    n = KNOBS_WINDOW * BATCH
    window = tuple(torch.from_numpy(a[:n].reshape((KNOBS_WINDOW, BATCH)
                                                  + a.shape[1:])).to(
        model.device) for a in (xs[0], y))
    start = (dict(model._params), model._opt_state, model._step)
    with deterministic_cudnn():
        wl, _ = model.train_window(window)
        got = host_state(model)
        restore(model, start)
        bl = torch.stack([model.train_batch(window[0][i], window[1][i])
                          for i in range(KNOBS_WINDOW)])
        want = host_state(model)
    diff = max_diff(got, want)
    assert torch.equal(wl, bl) and diff == 0.0, (wl, bl, diff)
    print(f"resnet50 train_window of {KNOBS_WINDOW} == {KNOBS_WINDOW} "
          f"train_batch calls from one state: losses, parameters, running "
          f"statistics and momentum bit-equal (cuDNN deterministic) "
          f"[{card}]")
    return launches


def checkpoint_phase(ft, cuda_pool, card: str) -> dict:
    """ResNet-50 with BatchNorm (bf16, batch 64, SGD with momentum) on
    the card: save at step 3, train 2 steps, load, train the same 2:
    parameters, running statistics and momentum bit-equal; the same with
    an async write overlapping the 2 steps; the file verifies and a copy
    with one flipped byte raises CorruptCheckpointError.  Save and load
    times and sizes.  Returns the max-pool launches."""
    import shutil

    from flexflow_tpu_torch.resilience import (CorruptCheckpointError,
                                               verify_checkpoint)

    _, image, classes, pools = CNNS["resnet50"]
    model = resnet_knobs_model(ft)
    xs, y = ft.synthetic_dataset(5 * BATCH, [(3, image, image)], (1,),
                                 num_classes=classes, seed=SEED + 1)
    batches = [model._device_batch((xs[0][i * BATCH:(i + 1) * BATCH],
                                    y[i * BATCH:(i + 1) * BATCH]))
               for i in range(5)]
    ckdir = os.path.join(HERE, "build", "checkpoint_smoke")
    shutil.rmtree(ckdir, ignore_errors=True)
    os.makedirs(ckdir)
    reset_counts(cuda_pool.max_pool_nhwc, cuda_pool.max_pool_nhwc_backward)
    steps = 0
    try:
        with deterministic_cudnn():
            for b in batches[:3]:
                model.train_batch(*b)
            steps += 3
            path = os.path.join(ckdir, "resnet50_step3.npz")
            t0 = time.perf_counter()
            model.save_checkpoint(path)
            save_s = time.perf_counter() - t0
            size = os.path.getsize(path)
            for b in batches[3:]:
                model.train_batch(*b)
            want = host_state(model)
            t0 = time.perf_counter()
            model.load_checkpoint(path)
            load_s = time.perf_counter() - t0
            assert model._step == 3, model._step
            for b in batches[3:]:
                model.train_batch(*b)
            steps += 4
            diff = max_diff(host_state(model), want)
            assert diff == 0.0, f"resumed run differs by {diff}"

            model.load_checkpoint(path)
            apath = os.path.join(ckdir, "resnet50_async_step3.npz")
            t0 = time.perf_counter()
            model.save_checkpoint(apath, async_write=True)
            call_s = time.perf_counter() - t0
            for b in batches[3:]:
                model.train_batch(*b)
            model.wait_for_checkpoint()
            async_s = time.perf_counter() - t0
            adiff_run = max_diff(host_state(model), want)
            model.load_checkpoint(apath)
            for b in batches[3:]:
                model.train_batch(*b)
            steps += 4
            adiff = max_diff(host_state(model), want)
            assert adiff == 0.0 and adiff_run == 0.0, (adiff, adiff_run)
        assert verify_checkpoint(path) and verify_checkpoint(apath)
        raw = bytearray(open(path, "rb").read())
        raw[len(raw) // 2] ^= 0x01
        bad = os.path.join(ckdir, "flipped.npz")
        with open(bad, "wb") as f:
            f.write(raw)
        assert not verify_checkpoint(bad)
        try:
            model.load_checkpoint(bad)
        except CorruptCheckpointError as e:
            assert "flipped.npz" in str(e), e
        else:
            raise AssertionError("a flipped byte loaded without an error")
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    launches = {"fwd": cuda_pool.max_pool_nhwc.launches,
                "bwd": cuda_pool.max_pool_nhwc_backward.launches}
    assert launches == {"fwd": pools * steps, "bwd": pools * steps}, launches
    trainable = sum(p.volume for p in model.parameters if p.trainable)
    mb = size / 1e6
    print(f"checkpoint: resnet50 {trainable} trainable parameters + "
          f"{model.num_parameters - trainable} running statistics + "
          f"momentum, {mb:.1f} MB; save {save_s * 1e3:.1f} ms "
          f"({mb / save_s:.0f} MB/s), load {load_s * 1e3:.1f} ms "
          f"({mb / load_s:.0f} MB/s); async save returned in "
          f"{call_s * 1e3:.1f} ms, written with 2 steps in "
          f"{async_s * 1e3:.1f} ms; resume after 2 steps bit-equal (sync "
          f"and async), verify_checkpoint True, a flipped byte raises "
          f"CorruptCheckpointError [{card}]")
    return launches


def moe_phase(ft, card: str) -> None:
    """One MoE layer at BERT-base's width (d 768, 8 experts, d_ff 3072,
    k 2, capacity factor 1.25) on 4 x 512 tokens: the forward, aux loss,
    loss and gradients, then one ``train_batch`` (the aux loss through
    the step and the optimizer), on the card against the port's own CPU
    run from the same weights (float32); then the forward and backward
    device times in float32 and bf16."""
    import numpy as np
    import torch

    rng = np.random.default_rng(SEED + 9)
    x = rng.standard_normal(MOE_SHAPE).astype(np.float32)
    y = (0.1 * rng.standard_normal(MOE_SHAPE)).astype(np.float32)

    def build(device, dtype):
        cfg = ft.FFConfig(batch_size=MOE_SHAPE[0], compute_dtype=dtype,
                          seed=SEED)
        m = ft.FFModel(cfg, device=device)
        t = m.create_tensor(MOE_SHAPE, name="x")
        t = m.moe(t, name="moe0", **MOE)
        m.compile(ft.SGDOptimizer(lr=0.01), "mean_squared_error", [],
                  final_tensor=t)
        m.init_layers(seed=SEED)
        return m

    got = {}
    for device in ("cuda", "cpu"):
        m = build(device, "float32")
        tokens = MOE_SHAPE[0] * MOE_SHAPE[1]
        assert m.layers[0].capacity == math.ceil(
            MOE["k"] * tokens / MOE["num_experts"]
            * MOE["capacity_factor"]), m.layers[0].capacity
        batch = m._device_batch((x, y))
        out = m.predict(x, batch_size=MOE_SHAPE[0])
        aux = {}
        m._forward_values(m._params, batch[:1], training=True,
                          seed=m._step_seed(0), aux_losses=aux)
        loss, _, grads, _, _ = m._loss_and_grads(batch, m._step_seed(0))
        before = {k: v.detach().cpu().clone() for k, v in m._params.items()}
        step_loss = m.train_batch(x, y)
        # train_batch's objective is the one above, aux loss included
        assert abs(float(step_loss) - float(loss)) <= MOE_TOL * abs(
            float(loss)), (device, float(step_loss), float(loss))
        got[device] = ({"out": torch.from_numpy(out),
                        "aux": aux["moe0"].detach().cpu().reshape(1),
                        "loss": loss.cpu().reshape(1)},
                       {k: g.cpu() for k, g in grads.items()},
                       {"step loss": step_loss.cpu().reshape(1)},
                       {k: m._params[k].detach().cpu() - v
                        for k, v in before.items()})
    errs = {}
    for part in (0, 1, 2):
        for k, want in got["cpu"][part].items():
            have = got["cuda"][part][k]
            scale = max(float(want.abs().max()), 1e-30)
            errs[k] = float((have - want).abs().max()) / scale
    # each parameter's update against that parameter's own largest update
    upd_cpu, upd_card = got["cpu"][3], got["cuda"][3]
    assert set(upd_cpu) == set(upd_card) == set(got["cpu"][1]), upd_cpu
    for k, u in upd_cpu.items():
        scale = float(u.abs().max())
        assert scale > 0, (k, scale)
        errs[f"update {k}"] = float((upd_card[k] - u).abs().max()) / scale
    upd_err = max(v for k, v in errs.items() if k.startswith("update "))
    worst = max(errs, key=errs.get)
    print(f"moe card vs cpu (float32, {MOE_SHAPE[0] * MOE_SHAPE[1]} tokens, "
          f"C {m.layers[0].capacity}): largest error over the largest reference value "
          f"{errs[worst]:.3g} ({worst}); out {errs['out']:.3g}, aux "
          f"{errs['aux']:.3g}, loss {errs['loss']:.3g}, gradients "
          f"{max(v for k, v in errs.items() if k in got['cpu'][1]):.3g}; train_batch "
          f"loss {errs['step loss']:.3g}, parameter updates {upd_err:.3g} "
          f"(tolerance {MOE_TOL}) [{card}]")
    assert errs[worst] <= MOE_TOL, errs
    for dtype in ("float32", "bfloat16"):
        m = build("cuda", dtype)
        batch = m._device_batch((x, y))
        fwd = m.forward_compiled(MOE_SHAPE[0])
        fwd_ms = time_ms(lambda b: fwd(m._params, b[:1]), [batch], 10)
        step_ms = time_ms(lambda b: m._loss_and_grads(b, 0), [batch], 10)
        print(f"moe timing ({dtype}): forward {fwd_ms:.4f} ms, forward + "
              f"backward {step_ms:.4f} ms (backward {step_ms - fwd_ms:.4f} "
              f"ms) device time [{card}]")


def memory_estimate(model) -> float:
    """The verifier's analytic high-water of one training step of
    ``model`` (its FF108 scalar before the compiler-temp factor): the
    simulator ``analysis.verify_compile`` runs, over the resolved
    strategy and mesh."""
    from flexflow_tpu_torch.search.simulator import Simulator

    sim = Simulator(num_devices=1,
                    opt_slot_bytes=model.optimizer.slot_bytes_per_param,
                    sparse_tables=frozenset(
                        t for _, t, _ in model._sparse_specs))
    strategies = {op.name: op.parallel_config for op in model.layers
                  if op.parallel_config is not None}
    return sim.peak_memory_bytes(model.layers, strategies,
                                 dict(model.mesh.sizes), assume_remat=False)


def record_memory(model, peak: int, label: str, card: str) -> None:
    import torch

    est = memory_estimate(model)
    MEMORY.append({"step": label, "peak_bytes": int(peak),
                   "estimate_bytes": est, "ratio": peak / est})
    print(f"memory {label}: peak {peak / 2**30:.3f} GiB allocated over the "
          f"step ({torch.cuda.memory_allocated() / 2**30:.3f} GiB held "
          f"after it), analytic high-water {est / 2**30:.3f} GiB, ratio "
          f"{peak / est:.4f} [{card}]")


def free_garbage() -> None:
    """Collect what earlier phases left in reference cycles, so a peak
    counts the live model and no dead one."""
    import gc

    import torch

    gc.collect()
    torch.cuda.synchronize()


def step_memory(model, batch, label: str, card: str) -> int:
    """One train_batch's peak allocation (``max_memory_allocated`` after
    a reset), recorded beside the analytic high-water."""
    import torch

    free_garbage()
    torch.cuda.reset_peak_memory_stats()
    model.train_batch(*batch)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    record_memory(model, peak, label, card)
    return peak


def write_strategy(name: str, strategies) -> str:
    from flexflow_tpu_torch.strategy import save_strategy_file

    os.makedirs(STRATEGY_DIR, exist_ok=True)
    path = os.path.join(STRATEGY_DIR, name)
    save_strategy_file(path, strategies)
    return path


def pinned_tables(model, when: str) -> list:
    """The host-placed tables, each asserted a pinned host tensor."""
    names = sorted(model._host_params)
    for n in names:
        t = model._params[n]
        assert t.device.type == "cpu" and t.is_pinned(), (when, n, t.device)
    return [model._params[n] for n in names]


def dlrm_hetero_phase(ft, card: str, counters) -> None:
    """DLRM at full width under the reference's hetero strategy for one
    GPU (its four 1,000,000 x 64 tables on the host), imported from a
    ``.pb``: the forward bit-equal to the device-placed model from the
    same weights, each step's peak memory beside the device-placed one,
    serving and training through the usual entry points with the tables
    pinned on the host throughout, the host's gather and row-update
    times, a dense update (momentum, on the card) timed, and a small float32
    version's 3 steps on the card against the CPU."""
    import numpy as np
    import torch
    from flexflow_tpu_torch.ops.linear import host_gather
    from flexflow_tpu_torch.strategy.dlrm_gen import \
        generate_dlrm_hetero_strategy

    reset_counts(*counters)
    path = write_strategy("dlrm_strategy_4nEmb_1cpu_1gpu.pb",
                          generate_dlrm_hetero_strategy(
                              gpus=1, cpus=1, num_embeddings=4))
    batch = ZOO["dlrm"][2]
    t0 = time.perf_counter()
    model = build_zoo(ft, "dlrm", batch, import_strategy_file=path)
    tables = pinned_tables(model, "after init")
    report = model.verify_report
    print(f"dlrm hetero: {os.path.relpath(path, HERE)} imported, "
          f"{len(tables)} tables pinned on the host "
          f"({sum(t.nbytes for t in tables) / 2**30:.3f} GiB), row update "
          f"on the host for {len(model._host_rows)}, built and initialised "
          f"in {time.perf_counter() - t0:.3f}s; verifier {report.counts()} "
          f"({sorted(set(report.codes()))}) [{card}]")
    assert len(tables) == 4 and len(model._host_rows) == 4, \
        model._host_params
    assert not model._sparse_specs and not report.errors
    rng = np.random.default_rng(SEED + 2)
    xs, y = zoo_batch(model, batch, rng)
    out_h = model.predict(xs, batch_size=batch)
    xb = model._to_device(tuple(xs) + (y,))
    peak_h = step_memory(model, xb, "dlrm hetero step (bf16, batch "
                         f"{batch})", card)
    pinned_tables(model, "after a step")

    device = build_zoo(ft, "dlrm", batch)   # the same seed: same weights
    out_d = device.predict(xs, batch_size=batch)
    assert np.array_equal(out_h, out_d), float(np.abs(out_h - out_d).max())
    peak_d = step_memory(device, xb, f"dlrm device-placed step (bf16, "
                         f"batch {batch}, sparse update)", card)
    table_b = sum(t.nbytes for t in tables)
    print(f"dlrm hetero forward == device-placed forward from the same "
          f"weights (bit-equal, {out_h.shape[0]} rows); peak over a step "
          f"{peak_h / 2**30:.3f} GiB against {peak_d / 2**30:.3f} GiB "
          f"device-placed: {(peak_d - peak_h) / 2**30:.3f} GiB left the "
          f"card (the tables are {table_b / 2**30:.3f} GiB) [{card}]")
    assert peak_d - peak_h > 0.9 * table_b, (peak_h, peak_d, table_b)
    del device
    torch.cuda.empty_cache()

    zoo_serve(ft, "dlrm", model, card, label="dlrm hetero")
    xb = zoo_train(ft, "dlrm", model, card, label="dlrm hetero")
    pinned_tables(model, "after fit and train_batch")
    for i in range(3):
        model.train_batch(*xb)
        assert [model._params[n] for n in sorted(model._host_params)] == \
            tables
        pinned_tables(model, f"after step {i}")

    # the host's share of a step: the four gathers (ids to the host, the
    # gather, the rows to the card) and the four row updates
    ids = [xb[pos] for _, _, pos in model._host_rows]
    grads = {op: torch.zeros((batch, 1, 64), device=model.device)
             for op, _, _ in model._host_rows}

    def host_ms(fn, reps=10) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / reps

    gather_ms = host_ms(lambda: [host_gather(t, i, model.device)
                                 for t, i in zip(tables, ids)])
    update_ms = host_ms(lambda: model._apply_sparse_update(xb, grads))
    wall = host_ms(lambda: model.train_batch(*xb))
    print(f"dlrm hetero host work a step: gathers {gather_ms:.4f} ms, row "
          f"updates {update_ms:.4f} ms (4 tables, {batch} ids each), of a "
          f"{wall:.4f} ms step wall [{card}]")
    launches = [fn.launches for fn in counters]
    assert launches == [0] * len(counters), launches
    del model
    torch.cuda.empty_cache()

    # SGD with momentum moves every row the velocity holds: the dense
    # path, the whole tables' gradient built on the host and the update
    # on the card, which each table visits for it
    dense = build_zoo(ft, "dlrm", batch, import_strategy_file=path,
                      momentum=0.9)
    assert not dense._host_rows
    dense.train_batch(*xb)
    t0 = time.perf_counter()
    for _ in range(HETERO_DENSE_STEPS):
        dense.train_batch(*xb)
    torch.cuda.synchronize()
    dense_ms = (time.perf_counter() - t0) * 1e3 / HETERO_DENSE_STEPS
    pinned_tables(dense, "after dense steps")
    print(f"dlrm hetero dense update (SGD momentum 0.9: each table's whole "
          f"gradient built on the host, the update on the card): "
          f"{dense_ms:.1f} ms wall a step over {HETERO_DENSE_STEPS} steps "
          f"[{card}]")
    del dense

    kw = ZOO_SMALL["dlrm"]
    small = write_strategy("dlrm_strategy_small_hetero.pb",
                           generate_dlrm_hetero_strategy(
                               gpus=1, cpus=1, num_embeddings=4))
    runs = []
    for dev in ("cuda", "cpu"):
        m = build_zoo(ft, "dlrm", 16, device=dev, compute_dtype="float32",
                      import_strategy_file=small, **kw)
        assert len(m._host_rows) == 4
        rng = np.random.default_rng(SEED)
        batches = [zoo_batch(m, 16, rng) for _ in range(3)]
        losses = [float(m.train_batch(*x, yy)) for x, yy in batches]
        runs.append((np.array(losses), {p.name: m.get_weights(p.name)
                                        for p in m.parameters}))
    (l_c, w_c), (l_h, w_h) = runs
    loss_err = float(np.abs(l_c - l_h).max())
    param_err = max(float(np.abs(w_c[k] - w_h[k]).max()) for k in w_h)
    assert loss_err <= F32_STEP_TOL and param_err <= F32_STEP_TOL, (
        loss_err, param_err)
    print(f"f32 dlrm hetero 3 SGD steps cuda vs cpu: losses "
          f"{np.round(l_c, 6).tolist()}, max abs err {loss_err:.3g}, max "
          f"abs err over the parameters {param_err:.3g} (tolerance "
          f"{F32_STEP_TOL})")


def pinned_bert(ft, compute_dtype: str, path: str = "", device=None,
                arch=None, batch: int = BERT_BATCH):
    """BERT-base (or ``arch``) with SGD, importing the strategy at
    ``path`` when given; weights from SEED."""
    from flexflow_tpu_torch.models import build_transformer

    cfg = ft.FFConfig(batch_size=batch, compute_dtype=compute_dtype,
                      seed=SEED, import_strategy_file=path)
    model, _, logits = build_transformer(cfg, device=device,
                                         **(arch or BERT))
    model.compile(ft.SGDOptimizer(lr=REMAT_LR), final_tensor=logits)
    model.init_layers(seed=SEED)
    return model


def bert_precision_phase(ft, counters, card: str) -> dict:
    """BERT-base (batch 16) in a float32 session with a strategy pinning
    its 12 attention ops to bf16: the verifier's FF141 row, the flash
    kernels' launches and dtype a forward and a step, the output against
    the unpinned float32 run and, at small width, against the CPU; the
    forward's and the step's device time beside the all-f32 and all-bf16
    runs.  Returns the kernels' launches of the pinned run."""
    import numpy as np
    import torch

    fwd_k, bwd_k, ln_k = counters
    layers = BERT["num_layers"]
    pins = {f"attention_{i}": ft.ParallelConfig(
        dims=(1, 1, 1), device_ids=(0,), precision="bf16")
        for i in range(layers)}
    path = write_strategy("bert_attention_bf16.pb", pins)
    model = pinned_bert(ft, "float32", path)
    report = model.verify_report
    ff141 = [d for d in report if d.code == "FF141"]
    assert len(ff141) == 1 and not report.errors, report.render_text()
    print(f"bert pinned: {os.path.relpath(path, HERE)} imported; verifier "
          f"{report.counts()}: {ff141[0].render()} [{card}]")
    xb, yb = bert_batch(model)
    fwd = model.forward_compiled(BERT_BATCH)
    reset_counts(*counters)
    with torch.inference_mode():
        out_p = fwd(model._params, (xb,)).float().cpu().numpy()
    launches = {"fwd": fwd_k.launches, "bwd": bwd_k.launches,
                "ln": ln_k.launches}
    by_dtype = dict(fwd_k.launches_by_dtype)
    assert launches == {"fwd": layers, "bwd": 0, "ln": 2 * layers} and \
        by_dtype == {"torch.bfloat16": layers}, (launches, by_dtype)
    reset_counts(*counters)
    model.train_batch(xb, yb)
    step = {"fwd": fwd_k.launches, "bwd": bwd_k.launches, "ln": ln_k.launches}
    assert step == {"fwd": layers, "bwd": layers, "ln": 2 * layers} and \
        fwd_k.launches_by_dtype == {"torch.bfloat16": layers} and \
        bwd_k.launches_by_dtype == {"torch.bfloat16": layers}, (
            step, fwd_k.launches_by_dtype, bwd_k.launches_by_dtype)
    print(f"bert pinned launches: a forward {launches['fwd']} flash "
          f"forward, all bf16 ({by_dtype}); a step {step['fwd']} + "
          f"{step['bwd']} flash (bf16), layernorm {step['ln']} (float32 "
          f"session) [{card}]")
    total = {k: launches[k] + step[k] for k in launches}

    times = {}
    plain = None
    for label, dtype, p in (("f32", "float32", ""), ("pinned", "float32",
                                                      path),
                            ("bf16", "bfloat16", "")):
        m = model if label == "pinned" else pinned_bert(ft, dtype, p)
        f = m.forward_compiled(BERT_BATCH)
        if label == "f32":
            with torch.inference_mode():
                plain = f(m._params, (xb,)).float().cpu().numpy()
        fwd_ms = time_ms(lambda t: f(m._params, t), [(xb,)], 5,
                         spin_cycles=1_000_000_000)
        step_ms = time_ms(lambda b: m.train_batch(*b), [(xb, yb)], 3,
                          spin_cycles=3_000_000_000)
        times[label] = (fwd_ms, step_ms)
        if label != "pinned":
            del m, f
            torch.cuda.empty_cache()
    err = float(np.abs(out_p - plain).max())
    print(f"bert pinned vs unpinned float32 (same weights): class "
          f"probabilities max abs diff {err:.4g} (tolerance "
          f"{PIN_VS_F32_TOL}) [{card}]")
    assert err <= PIN_VS_F32_TOL and np.isfinite(out_p).all(), err
    for label, (f_ms, s_ms) in times.items():
        print(f"bert {label} (batch {BERT_BATCH}): forward {f_ms:.4f} ms, "
              f"step {s_ms:.4f} ms device time [{card}]")
    del model, fwd
    torch.cuda.empty_cache()

    # the strategy at small width: card against CPU, float32 session,
    # attention in bf16 (flash kernels on the card, the dense path on
    # the CPU), logits compared
    small_pins = {f"attention_{i}": pins[f"attention_{i}"]
                  for i in range(PIN_SMALL["num_layers"])}
    small = write_strategy("small_attention_bf16.pb", small_pins)
    rng = np.random.default_rng(SEED)
    x = rng.integers(0, PIN_SMALL["vocab_size"],
                     (2, PIN_SMALL["seq_len"])).astype(np.int32)
    outs = []
    for dev in ("cuda", "cpu"):
        m = pinned_bert(ft, "float32", small, device=dev, arch=PIN_SMALL,
                        batch=2)
        logits = m._loss_tensor
        vals = m._forward_values(m._params, m._to_device((x,)))
        outs.append(vals[logits.uid].float().cpu().numpy())
    scale = float(np.abs(outs[1]).max())
    small_err = float(np.abs(outs[0] - outs[1]).max())
    assert small_err <= FLASH_LOW_TOL * max(scale, 1.0), (small_err, scale)
    print(f"bert pinned small (2 x 128, s 128) cuda (flash bf16) vs cpu "
          f"(dense bf16): logits max abs err {small_err:.4g} of "
          f"{scale:.4g} (tolerance {FLASH_LOW_TOL} of the largest) [{card}]")
    return total


def verifier_phase(ft, card: str) -> None:
    """verify() device-free over the committed searched strategies, each
    with its model at the file's batch and device count: the error,
    warning and info counts per file."""
    from flexflow_tpu_torch import models
    from flexflow_tpu_torch.analysis import verify
    from flexflow_tpu_torch.strategy import load_strategy_file

    assert SEARCHED, "no committed searched strategy to verify"
    for fname, builder, batch, ndev in SEARCHED:
        t0 = time.perf_counter()
        model = getattr(models, builder)(ft.FFConfig(batch_size=batch))[0]
        strategies = load_strategy_file(os.path.join(HERE, "artifacts",
                                                     fname))
        report = verify(model.layers, strategies, num_devices=ndev,
                        input_tensors=model.input_tensors,
                        final_tensors=model.layers[-1].outputs,
                        parameters=model.parameters)
        c = report.counts()
        print(f"verify {fname} ({builder}, batch {batch}, {ndev} devices, "
              f"{len(strategies)} entries): {c.get('ERROR', 0)} error, "
              f"{c.get('WARN', 0)} warning, {c.get('INFO', 0)} info "
              f"({sorted(set(report.codes()))}), "
              f"{(time.perf_counter() - t0) * 1e3:.1f} ms [{card}]")
        assert not report.errors, report.render_text()


# ---- paged token generation ---------------------------------------------
def gen_traffic(rng, vocab: int) -> list:
    """GEN_REQUESTS prompts from the seed: even ones uniform in length over
    GEN_PROMPT, odd ones the shared GEN_PREFIX-token prefix and a suffix,
    their length uniform over (GEN_PREFIX, GEN_PROMPT[1]]."""
    import numpy as np

    prefix = rng.integers(0, vocab, GEN_PREFIX)
    lo, hi = GEN_PROMPT
    out = []
    for i in range(GEN_REQUESTS):
        if i % 2:
            n = int(rng.integers(GEN_PREFIX + 1, hi + 1))
            p = np.concatenate([prefix, rng.integers(0, vocab,
                                                     n - GEN_PREFIX)])
        else:
            p = rng.integers(0, vocab, int(rng.integers(lo, hi + 1)))
        out.append(p.astype(np.int32))
    return out


def gen_kernel_checks(cuda_attention, cuda_norm) -> dict:
    """The two kernels of the generation path at the shapes it gives
    them, against their plain versions, and timed: the LayerNorm kernel
    at a decode step's 16 rows and a prefill chunk's 256 (bf16 in, f32
    and bf16 out, d 768), the causal flash forward at the reference
    forward's (4, 1024, 12, 64) in bf16."""
    import torch
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    dev = gen.device
    d = GPT2["d_model"]
    ln_rows = []
    for shape in ((GEN_SLOTS, 1, d), (1, GEN_CHUNK, d)):
        x = (3 * torch.randn(shape, generator=gen, device=dev)
             + 1).to(torch.bfloat16)
        scale = torch.randn(d, generator=gen, device=dev)
        bias = torch.randn(d, generator=gen, device=dev)
        err = ln_check(cuda_norm, x, None, scale, bias, " (generation)")
        ln_rows += ln_timing_rows(cuda_norm, x, scale, bias,
                                  path="generation", max_abs_err=err)

    n, s = GEN_CHECKED[0], GPT2["seq_len"]
    h = GPT2["num_heads"]
    hd = d // h
    scale = hd ** -0.5
    q, k, v = (torch.randn((n, s, h, hd), generator=gen,
                           device=dev).to(torch.bfloat16) for _ in range(3))
    o, lse = cuda_attention.flash_attention_forward(q, k, v, True, scale)
    torch.cuda.synchronize()
    ref = cuda_attention.flash_attention_reference(q, k, v, True, scale)
    diff = (o.float() - ref).abs()
    err = float(diff.max())
    tol = FLASH_LOW_TOL * float(ref.abs().max())
    worst = float((diff.amax(-1) / ref.abs().amax(-1).clamp_min(1e-30)).max())
    rms = rms_rel(o, ref)
    lse_err = float((lse - cuda_attention.flash_attention_lse_reference(
        q, k, True, scale)).abs().max())
    print(f"flash kernel vs plain (generation's reference shape): bf16 "
          f"causal=True (n,s,h,d)=({n},{s},{h},{hd}) forward max abs err "
          f"{err:.3g} (tol {tol:.3g}), worst row {worst:.3g}, lse "
          f"{lse_err:.3g} (tol {FLASH_LSE_TOL}), RMS-relative O {rms:.3g}")
    assert err <= tol and worst <= FLASH_LOW_ROW_TOL, (err, tol, worst)
    assert rms <= FLASH_LOW_RMS_TOL and lse_err <= FLASH_LSE_TOL, \
        (rms, lse_err)
    del o, lse, ref, diff
    sets = [(q, k, v)] + [tuple(torch.randn(
        (n, s, h, hd), generator=gen, device=dev).to(torch.bfloat16)
        for _ in range(3)) for _ in range(7)]
    lib = [tuple(t.transpose(1, 2).contiguous() for t in st) for st in sets]
    b_ms, b_by, b_bytes, b_ops = flash_bounds(n, s, s, h, hd, 2, True, False)
    flash_row = {
        "shape": [n, s, h, hd], "dtype": "bf16", "causal": True,
        "path": "generation", "max_abs_err": err, "design": FLASH_DESIGN,
        "kernel_ms": time_ms(lambda t: cuda_attention.flash_attention_forward(
            t[0], t[1], t[2], True, scale), sets, 50),
        "plain_ms": time_ms(lambda t: cuda_attention.flash_attention_reference(
            t[0], t[1], t[2], True, scale), sets, 5),
        "library_ms": time_ms(lambda t: F.scaled_dot_product_attention(
            t[0], t[1], t[2], scale=scale, is_causal=True), lib, 50),
        "bound_ms": b_ms, "bound_by": b_by, "bytes": b_bytes, "ops": b_ops,
    }
    print("flash forward timing: " + json.dumps(flash_row))
    del sets, lib
    torch.cuda.empty_cache()
    return {"ln": ln_rows, "flash": flash_row}


def gen_capture(eng):
    """Record the logits the running engine computes for each stream
    (keyed by ``id(stream)``): the last real position of its final
    prefill chunk, then each decode step's.  Undone by deleting the two
    attributes from ``eng._decoder``."""
    rec = {}
    dec = eng._decoder
    walk_prefill, walk_decode = dec._walk_prefill, dec._walk_decode

    def prefill(params, caches, tokens, row, slot, start, length):
        out = walk_prefill(params, caches, tokens, row, slot, start, length)
        # a prompt's later chunk replaces its earlier one's logits
        rec[id(eng._slots_state[slot].stream)] = [out.float().clone()]
        return out

    def decode(params, caches, tokens, pos, table, ws, wp, wr):
        out = walk_decode(params, caches, tokens, pos, table, ws, wp, wr)
        for i, s in enumerate(eng._slots_state):
            if s is not None and not s.prefilling:
                rec[id(s.stream)].append(out[i].float().clone())
        return out

    dec._walk_prefill, dec._walk_decode = prefill, decode
    return rec


def gen_reference(model, prompts, outs, counted) -> "torch.Tensor":
    """The full forward (``forward_compiled``, one bucket of
    GEN_CHECKED[0] rows, the causal flash kernel) over each prompt and
    its generated tokens but the last: the float32 logits (len(prompts),
    len(outs[0]), V) at the positions that chose the generated tokens.
    At most GEN_CHECKED[0] prompts; the forward's flash launches, the
    count set to 0 just before it, are added to ``counted["ref"]``."""
    import numpy as np
    import torch
    from flexflow_tpu_torch.ops import cuda_attention

    fwd_k = cuda_attention.flash_attention_forward
    nb, ntok = GEN_CHECKED[0], len(outs[0])
    batch = np.zeros((nb, GPT2["seq_len"]), np.int32)
    idx = np.zeros((nb, ntok), np.int64)
    for i, (p, o) in enumerate(zip(prompts, outs)):
        full = np.concatenate([p, o[:-1]])
        batch[i, :len(full)] = full
        idx[i] = len(p) - 1 + np.arange(ntok)
    xb = model._to_device((batch,))
    reset_counts(fwd_k)
    out = model.forward_compiled(nb)(model._params, xb)
    counted["ref"] += fwd_k.launches
    ix = torch.as_tensor(idx, device=out.device)[:, :, None]
    return out.gather(1, ix.expand(-1, -1, out.shape[-1])).float()[
        :len(prompts)]


def gen_decided(ref, tokens, tol: float):
    """(decided, agree): the positions whose reference top-2 logit gap
    exceeds ``tol``, and whether ``tokens`` (n, ntok) equal the
    reference's argmax at every one of them."""
    import torch

    top2 = ref.topk(2, dim=-1).values
    decided = ((top2[..., 0] - top2[..., 1]) > tol).cpu()
    ref_tok = ref.argmax(-1).cpu()
    tokens = torch.as_tensor(tokens)
    return decided, bool((tokens[decided] == ref_tok[decided]).all())


def gen_logit_check(eng, model, prompts, tol: float, counted) -> dict:
    """``prompts`` (at most GEN_CHECKED[0]) through the running engine,
    GEN_CHECKED[1] greedy tokens each, every step's logits captured and
    held against the full forward: the largest absolute error, whether
    the tokens equal the reference's where its top-2 gap exceeds
    ``tol``, and whether the check passes."""
    import torch

    ntok = GEN_CHECKED[1]
    dec = eng._decoder
    rec = gen_capture(eng)
    try:
        streams = [eng.submit(p, max_new_tokens=ntok) for p in prompts]
        outs = [s.result(timeout=300).tolist() for s in streams]
    finally:
        del dec._walk_prefill, dec._walk_decode
    got = torch.stack([torch.stack(rec[id(s)]) for s in streams])
    ref = gen_reference(model, prompts, outs, counted)
    decided, agree = gen_decided(ref, outs, tol)
    err = float((got - ref).abs().max())
    return {"err": err, "agree": agree, "passes": err <= tol and agree,
            "decided": int(decided.sum()), "positions": decided.numel(),
            "all_equal": bool((torch.tensor(outs)
                               == ref.argmax(-1).cpu()).all()),
            "rms": float(ref.pow(2).mean().sqrt())}


GEN_CONTROLS = ("bf16 scores", "mask off by one", "another slot's pages")


def gen_wrong_attention(kind: str):
    """A deliberately wrong paged attention, the logit check's control
    (in place of ``ops.attention._position_attention``): "bf16 scores"
    rounds QK^T to bf16 before the softmax; "mask off by one" lets each
    query see the next position too; "another slot's pages" attends
    each decode slot over its neighbour's gathered pages."""
    import torch
    from flexflow_tpu_torch.ops.attention import NEG_INF

    def wrong(q, kg, vg, qpos, scale):
        f32 = torch.float32
        if kind == "another slot's pages":
            kg, vg = kg.roll(1, 0), vg.roll(1, 0)
        if kind == "bf16 scores":
            bf16 = torch.bfloat16
            scores = torch.einsum("nqhd,nkhd->nhqk", q.to(bf16),
                                  kg.to(bf16)).to(f32) * scale
        else:
            scores = torch.einsum("nqhd,nkhd->nhqk", q.to(f32),
                                  kg.to(f32)) * scale
        shift = 1 if kind == "mask off by one" else 0
        kpos = torch.arange(kg.shape[1], device=kg.device)
        scores = scores.masked_fill(
            kpos[None, None, None, :] > qpos[:, None, :, None] + shift,
            NEG_INF)
        probs = torch.softmax(scores, dim=-1)
        return torch.einsum("nhqk,nkhd->nqhd", probs.to(vg.dtype).to(f32),
                            vg.to(f32))

    return wrong


def gen_checked_prompts(prefix, vocab: int) -> list:
    """GEN_CHECKED[0] new prompts from SEED + 1: odd ones the shared
    prefix and a suffix (they hit the warm engine's cached prefix pages
    and prefill at an offset), even ones fresh."""
    import numpy as np

    rng = np.random.default_rng(SEED + 1)
    lo, hi = GEN_PROMPT
    out = []
    for i in range(GEN_CHECKED[0]):
        if i % 2:
            n = int(rng.integers(GEN_PREFIX + 1, hi + 1))
            p = np.concatenate([prefix, rng.integers(0, vocab,
                                                     n - GEN_PREFIX)])
        else:
            p = rng.integers(0, vocab, int(rng.integers(lo, hi + 1)))
        out.append(p.astype(np.int32))
    return out


def gen_served_check(model, prompts, outs, counted, card) -> dict:
    """The served greedy tokens against the full forward: equal wherever
    the reference's top-2 gap exceeds GEN_LOGIT_TOL."""
    nb = GEN_CHECKED[0]
    decided = agree = 0
    for b0 in range(0, len(prompts), nb):
        rows = [o.tolist() for o in outs[b0:b0 + nb]]
        ref = gen_reference(model, prompts[b0:b0 + nb], rows, counted)
        d, a = gen_decided(ref, rows, GEN_LOGIT_TOL)
        decided += int(d.sum())
        agree += a
        del ref
    nbatch = -(-len(prompts) // nb)
    out = {"decided": decided, "positions": len(prompts) * len(outs[0]),
           "agree": agree == nbatch, "forwards": nbatch}
    print(f"generation served tokens vs full forward: {len(prompts)} x "
          f"{len(outs[0])} greedy tokens, equal at all {decided} of "
          f"{out['positions']} positions whose top-2 gap exceeds "
          f"{GEN_LOGIT_TOL}: {out['agree']} ({nbatch} forwards) [{card}]")
    return out


def gen_controlled_check(eng, model, checked, tol, counted, card,
                         label) -> dict:
    """On the running warm engine: ``checked`` prompts x GEN_CHECKED[1]
    tokens, every step's logits held against the full forward within
    ``tol``; then the same check with each wrong attention of
    GEN_CONTROLS in turn (last: their pages are wrong)."""
    from flexflow_tpu_torch.ops import attention

    hits0 = eng.stats()["prefix_hit_tokens"]
    sound = gen_logit_check(eng, model, checked, tol, counted)
    sound["hits"] = eng.stats()["prefix_hit_tokens"] - hits0
    print(f"generation vs full forward ({label}, warm engine, "
          f"{sound['hits']} prefix hit tokens): {len(checked)} prompts x "
          f"{GEN_CHECKED[1]} tokens, logits max abs err {sound['err']:.4g} "
          f"(tol {tol}, reference logits RMS {sound['rms']:.4g}), tokens "
          f"equal at {sound['decided']} of {sound['positions']} positions "
          f"whose top-2 gap exceeds the tolerance: {sound['agree']}; all "
          f"tokens equal the reference's argmax: {sound['all_equal']} "
          f"[{card}]")
    controls = {}
    plain = attention._position_attention
    for kind in GEN_CONTROLS:
        attention._position_attention = gen_wrong_attention(kind)
        try:
            c = gen_logit_check(eng, model, checked, tol, counted)
        finally:
            attention._position_attention = plain
        controls[kind] = c
        print(f"generation control ({label}, {kind}): logits max abs err "
              f"{c['err']:.4g} (tol {tol}), tokens equal where decided: "
              f"{c['agree']}; fails the check: {not c['passes']} [{card}]")
    return {"sound": sound, "controls": controls}


def gen_f32_check(ft, prompts, counted, card) -> dict:
    """The controlled check again on a float32 twin of the LM (the same
    seed's weights, float32 compute, the same engine settings), warmed
    by the first GEN_SLOTS requests of the traffic (4 tokens each):
    bf16 rounds every logit to a grid (0.0039 near 0.5) coarser than
    what a wrong mask moves at these widths, float32 does not."""
    import torch

    cfg = ft.FFConfig(batch_size=GEN_CHECKED[0], compute_dtype="float32",
                      seed=SEED)
    cfg.serve_kv_page = GEN_PAGE
    cfg.serve_prefix_cache = "on"
    cfg.serve_prefill_chunk = GEN_CHUNK
    model, _, logits = ft.build_transformer_lm(cfg, **GPT2)
    model.compile(final_tensor=logits)
    model.init_layers(seed=SEED)
    with ft.GenerationEngine(model, slots=GEN_SLOTS) as eng:
        for s in [eng.submit(p, max_new_tokens=4)
                  for p in prompts[:GEN_SLOTS]]:
            s.result(timeout=300)
        out = gen_controlled_check(
            eng, model, gen_checked_prompts(prompts[1][:GEN_PREFIX],
                                            GPT2["vocab_size"]),
            GEN_F32_LOGIT_TOL, counted, card, "float32")
    del model, eng
    free_garbage()
    torch.cuda.empty_cache()
    return out


def gen_step_timing(model, card) -> dict:
    """A full decode step (16 active slots at positions 400-415) and a
    256-token prefill chunk at offset 256, straight through the decoder:
    device time by CUDA events behind a GPU spin, wall time to the token
    fetch, and the profiler's busy time; plus the LayerNorm and flash
    launches of one call of each."""
    import numpy as np
    import torch
    from flexflow_tpu_torch.ops import cuda_attention, cuda_norm
    from flexflow_tpu_torch.serving.generation import GraphDecoder

    dec = GraphDecoder.for_model(model, GEN_SLOTS, GPT2["seq_len"],
                                 page_size=GEN_PAGE)
    caches = dec.init_cache()
    pps = dec.pages_per_slot
    rng = np.random.default_rng(SEED)
    table = np.arange(GEN_SLOTS * pps, dtype=np.int32).reshape(
        GEN_SLOTS, pps)
    pos = (min(400, GPT2["seq_len"] // 2 - GEN_SLOTS)
           + np.arange(GEN_SLOTS, dtype=np.int32))
    tokens = rng.integers(0, GPT2["vocab_size"], GEN_SLOTS)
    wp = table[np.arange(GEN_SLOTS), pos // GEN_PAGE]
    wr = pos % GEN_PAGE
    decode = dec.decode_fn()
    chunk = rng.integers(0, GPT2["vocab_size"], (1, GEN_CHUNK))
    prefill = dec.prefill_fn(GEN_CHUNK)

    def step(_=None):
        return decode(model._params, caches, tokens, pos, table, wp, wr)

    def chunk_call(_=None):
        return prefill(model._params, caches, chunk, table[0], 0, GEN_CHUNK,
                       GEN_CHUNK)

    sampled = dec.decode_sampled_fn()
    strategy = (np.full(GEN_SLOTS, GEN_SAMPLING["temperature"], np.float32),
                np.full(GEN_SLOTS, GEN_SAMPLING["top_k"], np.int32),
                np.full(GEN_SLOTS, GEN_SAMPLING["top_p"], np.float32),
                np.arange(GEN_SLOTS))

    def sampled_step(_=None):
        return sampled(model._params, caches, tokens, pos, table, wp, wr,
                       *strategy)

    ln, fl = cuda_norm.fused_layernorm, cuda_attention.flash_attention_forward
    counts = {}
    for name, fn in (("decode", step), ("chunk", chunk_call),
                     ("sampled", sampled_step)):
        reset_counts(ln, fl)
        fn().cpu()
        counts[name] = {"ln": ln.launches, "flash": fl.launches}
        # the call enqueues its work with no host sync: the step's one
        # sync is the caller's token fetch
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        out.cpu()
    walls = []
    for _ in range(20):
        t0 = time.perf_counter()
        step().cpu()
        walls.append((time.perf_counter() - t0) * 1e3)
    # device time by events behind a spin over the walks, their inputs
    # uploaded once: a call stages its inputs in a pinned block, and a
    # block made anew while the card spins waits for the card, which
    # puts host time between the events
    with torch.inference_mode():
        step_in = dec.decode_inputs(tokens, pos, table, wp, wr)
        chunk_in = dec._upload(chunk, table[0])

    def walk_step(_):
        with torch.inference_mode():
            return dec._walk_decode(model._params, caches,
                                    *step_in).argmax(-1)

    def walk_chunk(_):
        with torch.inference_mode():
            return dec._walk_prefill(model._params, caches, *chunk_in, 0,
                                     GEN_CHUNK, GEN_CHUNK).argmax()

    def one_call_ms(fn):
        # one call behind each spin, the median of five: the ~900
        # launches of a step fit the launch queue, ten steps' do not,
        # and an overflowing queue makes the host pace the card
        return float(np.median([time_ms(fn, [None], 1, warmup=1,
                                        spin_cycles=500_000_000)
                                for _ in range(5)]))

    out = {
        "decode_device_ms": one_call_ms(walk_step),
        "decode_wall_ms": float(np.median(walls)),
        "chunk_device_ms": one_call_ms(walk_chunk),
        "launches": counts,
    }
    print(f"generation step timing: decode step ({GEN_SLOTS} slots, "
          f"positions {pos[0]}-{pos[-1]}) {out['decode_device_ms']:.4f} ms "
          f"device (CUDA events, one call behind a GPU spin, inputs "
          f"uploaded once), "
          f"{out['decode_wall_ms']:.4f} ms wall to the "
          f"token fetch (median of 20); prefill chunk of {GEN_CHUNK} at "
          f"offset {GEN_CHUNK} {out['chunk_device_ms']:.4f} ms device; "
          f"launches of one call {json.dumps(counts)}; each call enqueued "
          f"with no host sync [{card}]")
    new_counts, old_counts = {}, {}
    busy = kernel_breakdown(step, PROFILED_STEPS, card, what="decode step",
                            counts=new_counts)
    out["decode_busy_ms"] = (sum(t for _, t in busy) / PROFILED_STEPS
                             / 1e3 if busy else None)
    # the same step with the LayerNorm op as it ran before its kernel
    # stored bf16: float32 out, then the op's cast to bf16
    from flexflow_tpu_torch.ops import norm as norm_op
    real = norm_op.fused_layernorm_autograd
    norm_op.fused_layernorm_autograd = (
        lambda x, r, sc, b, eps, out_dtype: real(x, r, sc, b, eps))
    try:
        old_busy = kernel_breakdown(
            step, PROFILED_STEPS, card,
            what="decode step (LayerNorm float32 out + cast)",
            counts=old_counts)
    finally:
        norm_op.fused_layernorm_autograd = real

    def launches(counts, ln=False):
        return sum(n for k, n in counts.items()
                   if not ln or "layernorm_kernel" in k)

    def per_step(counts, ln=False):
        # the window's launches over its steps, not rounded: a kernel
        # outside the steps would show as a fraction
        return launches(counts, ln) / PROFILED_STEPS

    layers = GPT2["num_layers"]
    out["kernels_per_step"] = {
        "bf16_out": per_step(new_counts), "ln": per_step(new_counts, True),
        "f32_out_cast": per_step(old_counts),
        "ln_f32_out_cast": per_step(old_counts, True),
        "busy_ms_f32_out_cast": (sum(t for _, t in old_busy)
                                 / PROFILED_STEPS / 1e3
                                 if old_busy else None)}
    k = out["kernels_per_step"]
    print(f"decode step device kernels (profiler, a step): "
          f"{k['bf16_out']:g} with the LayerNorm kernel storing bf16 "
          f"({k['ln']:g} LayerNorm launches), {k['f32_out_cast']:g} with "
          f"float32 out and the op's cast ({k['ln_f32_out_cast']:g} "
          f"LayerNorm launches): {k['f32_out_cast'] - k['bf16_out']:g} "
          f"fewer; busy {out['decode_busy_ms']} against "
          f"{k['busy_ms_f32_out_cast']} ms [{card}]")
    # names launched a number of times that is no multiple of the steps
    odd = {n[:60]: c for cs in (new_counts, old_counts)
           for n, c in cs.items() if c % PROFILED_STEPS}
    steps_ln = 2 * layers * PROFILED_STEPS
    assert launches(new_counts, True) == launches(old_counts, True) \
        == steps_ln, (k, odd)
    assert launches(old_counts) - launches(new_counts) == steps_ln, (k, odd)
    assert not odd, (k, odd)
    kernel_breakdown(chunk_call, 5, card, what="prefill chunk")
    assert counts["decode"] == {"ln": 2 * layers, "flash": 0}, counts
    assert counts["chunk"] == counts["sampled"] == {"ln": 2 * layers,
                                                    "flash": 0}, counts
    del caches
    return out


def generation_phase(ft, counters, card) -> dict:
    """Serve GPT-2 small's widths through GenerationEngine (see the module
    docstring); returns the kernel rows and launch counts."""
    import numpy as np
    import torch
    from flexflow_tpu_torch.analysis.kv_memory import kv_cache_bytes
    from flexflow_tpu_torch.ops import cuda_attention, cuda_norm
    from flexflow_tpu_torch.serving.metrics import quantiles

    fwd_k, bwd_k, ln_k = counters
    kchecks = gen_kernel_checks(cuda_attention, cuda_norm)
    free_garbage()
    cfg = ft.FFConfig(batch_size=GEN_CHECKED[0], compute_dtype="bfloat16",
                      seed=SEED)
    cfg.serve_kv_page = GEN_PAGE
    cfg.serve_prefix_cache = "on"
    cfg.serve_prefill_chunk = GEN_CHUNK
    model, _, logits = ft.build_transformer_lm(cfg, **GPT2)   # on cuda
    model.compile(final_tensor=logits)
    model.init_layers(seed=SEED)
    print(f"GPT-2 small widths: {model.num_parameters} parameters")
    prompts = gen_traffic(np.random.default_rng(SEED), GPT2["vocab_size"])
    torch.cuda.reset_peak_memory_stats()
    eng = ft.GenerationEngine(model, slots=GEN_SLOTS, metrics_window_s=3600)
    t0 = time.perf_counter()
    eng.start()
    warm = time.perf_counter() - t0
    alloc = sum(t.numel() * t.element_size() for sub in eng._caches.values()
                for t in sub.values())
    want = kv_cache_bytes(model.layers, None, GEN_SLOTS, GPT2["seq_len"],
                          kv_dtype_bytes=2, page_size=GEN_PAGE)
    print(f"KV pool: {eng.num_pages} pages of {eng.page_size} tokens, "
          f"{alloc} bytes allocated, kv_cache_bytes {want:.0f}, engine "
          f"kv_cache_bytes {eng.kv_cache_bytes:.0f}; start with warmup "
          f"{warm:.3f}s [{card}]")
    assert alloc == want == eng.kv_cache_bytes, (alloc, want)

    reset_counts(*counters)
    t0 = time.perf_counter()
    streams = [eng.submit(p, max_new_tokens=GEN_NEW) for p in prompts]
    outs = [s.result(timeout=900) for s in streams]
    wall = time.perf_counter() - t0
    snap = eng.stats()
    steps, chunks = eng._n_steps, eng._chunks_total
    sp = [ft.SamplingParams(seed=i, **GEN_SAMPLING)
          for i in range(GEN_SAMPLED)]
    t1 = time.perf_counter()
    sstreams = [eng.submit(p, max_new_tokens=GEN_NEW, sampling=s)
                for p, s in zip(prompts, sp)]
    sampled = [s.result(timeout=900).tolist() for s in sstreams]
    swall = time.perf_counter() - t1
    final = eng.stats()
    peak = torch.cuda.max_memory_allocated()
    launches = {"fwd": fwd_k.launches, "bwd": bwd_k.launches,
                "ln": ln_k.launches}
    layers = GPT2["num_layers"]
    dispatches = eng._n_steps + eng._chunks_total
    vocab = GPT2["vocab_size"]
    assert all(len(o) == GEN_NEW and 0 <= o.min() and o.max() < vocab
               for o in outs)
    assert all(len(o) == GEN_NEW for o in sampled)
    assert final["errors"] == 0 and final["requests"] == \
        GEN_REQUESTS + GEN_SAMPLED, final
    assert launches == {"fwd": 0, "bwd": 0, "ln": 2 * layers * dispatches}, \
        (launches, dispatches)
    ttft = quantiles([s.ttft for s in streams])
    print(f"generation serve: {GEN_REQUESTS} requests (prompts "
          f"{GEN_PROMPT[0]}-{GEN_PROMPT[1]} tokens, half behind one "
          f"{GEN_PREFIX}-token prefix), {GEN_NEW} greedy tokens each in "
          f"{wall:.3f}s: {GEN_REQUESTS * GEN_NEW / wall:.1f} tokens/s; TTFT "
          f"p50 {ttft[0.5] * 1e3:.1f} ms p99 {ttft[0.99] * 1e3:.1f} ms; "
          f"TPOT p50 {snap['tpot_p50_ms']} ms p99 {snap['tpot_p99_ms']} ms; "
          f"{steps} decode steps, {chunks} prefill chunks; pages high-water "
          f"{snap['kv_pages_high_water']} of {eng.num_pages}, prefix hit "
          f"tokens {snap['prefix_hit_tokens']} ({snap['prefix_hit_tokens'] // GEN_PAGE} "
          f"pages, rate {snap['prefix_hit_rate']}) [{card}]")
    print(f"generation sampled: {GEN_SAMPLED} requests "
          f"({json.dumps(GEN_SAMPLING)}) x {GEN_NEW} tokens in "
          f"{swall:.3f}s: {GEN_SAMPLED * GEN_NEW / swall:.1f} tokens/s; "
          f"launches over both runs: layernorm {launches['ln']} = "
          f"{2 * layers} x {dispatches} dispatches, flash forward "
          f"{launches['fwd']}, backward {launches['bwd']}; peak memory "
          f"{peak / 2**30:.3f} GiB [{card}]")
    # on the warm engine: every slot used, the shared prefix cached
    counted = {"ref": 0}
    served = gen_served_check(model, prompts, outs, counted, card)
    bf16 = gen_controlled_check(
        eng, model, gen_checked_prompts(prompts[1][:GEN_PREFIX], vocab),
        GEN_LOGIT_TOL, counted, card, "bf16")
    eng.stop()
    del eng
    free_garbage()
    f32 = gen_f32_check(ft, prompts, counted, card)
    nref = served["forwards"] + 2 * (1 + len(GEN_CONTROLS))
    print(f"flash forward launches on the reference path: "
          f"{counted['ref']} ({nref} forwards) [{card}]")
    # reproducibility: the sampled requests in two fresh engines, each
    # queued before it starts, so both run one schedule on one prefix
    # cache state (a prefix hit changes a prompt's chunking, and with it
    # the bf16 rounding, so a replay on the first engine's warm cache
    # need not give the same bits)
    replays = []
    for _ in range(2):
        e = ft.GenerationEngine(model, slots=GEN_SLOTS)
        rs = [e.submit(p, max_new_tokens=GEN_NEW, sampling=s)
              for p, s in zip(prompts, sp)]
        with e:
            replays.append([r.result(timeout=900).tolist() for r in rs])
        del e, rs
        free_garbage()
    same = replays[0] == replays[1]
    print(f"generation sampled replay: {GEN_SAMPLED} x {GEN_NEW} tokens "
          f"in two fresh engines, the same tokens: {same}; equal to the "
          f"first engine's sampled run (whose prompts hit its prefix "
          f"cache): {sum(a == b for a, b in zip(replays[0], sampled))} of "
          f"{GEN_SAMPLED} [{card}]")
    timing = gen_step_timing(model, card)
    del model
    free_garbage()
    lstm = gen_lstm_check(ft, card)
    assert same
    assert served["agree"], served
    assert counted["ref"] == layers * nref, counted
    for c in (bf16, f32):
        assert c["sound"]["passes"] and c["sound"]["hits"] > 0, c["sound"]
    # every control fails the float32 check; in bf16 only the gross one
    # leaves the rounding noise (PERF.md)
    assert not any(c["passes"] for c in f32["controls"].values()), f32
    assert not bf16["controls"]["another slot's pages"]["passes"], bf16
    # the engine's own launches, and the reference forwards' apart
    return {"ln": launches["ln"], "fwd": launches["fwd"],
            "ref_fwd": counted["ref"], "kernels": kchecks,
            "checks": {"served": served, "bf16": bf16, "float32": f32,
                       "lstm": lstm},
            "timing": timing}


def gen_lstm_check(ft, card) -> dict:
    """The LSTM LM through GenerationEngine on the card, float32, a few
    greedy requests, against the same engine on the CPU with the same
    weights: every token equal."""
    import numpy as np

    models = {}
    for dev in ("cuda", "cpu"):
        cfg = ft.FFConfig(batch_size=4, compute_dtype="float32", seed=SEED)
        m = ft.build_lstm_lm(cfg, device=dev, **LSTM_GEN)[0]
        m.compile()
        m.init_layers(seed=SEED)
        models[dev] = m
    for p in models["cuda"].parameters:
        models["cpu"].set_weights(p.name,
                                  models["cuda"].get_weights(p.name))
    rng = np.random.default_rng(SEED)
    vocab = LSTM_GEN["vocab_size"]
    prompts = [rng.integers(1, vocab, int(n))
               for n in rng.integers(4, 24, LSTM_GEN_PROMPTS)]
    toks = {}
    for dev, m in models.items():
        t0 = time.perf_counter()
        with ft.GenerationEngine(m, slots=4,
                                 max_new_tokens=LSTM_GEN_NEW) as eng:
            streams = [eng.submit(p) for p in prompts]
            toks[dev] = [s.result(timeout=300).tolist() for s in streams]
        toks[dev + "_s"] = time.perf_counter() - t0
    pairs = [(a, b) for x, y in zip(toks["cuda"], toks["cpu"])
             for a, b in zip(x, y)]
    equal = sum(a == b for a, b in pairs)
    print(f"lstm lm generation card vs cpu: {LSTM_GEN_PROMPTS} greedy "
          f"requests x {LSTM_GEN_NEW} tokens ({json.dumps(LSTM_GEN)}, "
          f"float32, slots 4): {equal} of {len(pairs)} tokens equal; "
          f"{toks['cuda_s']:.3f}s on the card, {toks['cpu_s']:.3f}s on "
          f"the CPU [{card}]")
    assert len(pairs) == LSTM_GEN_PROMPTS * LSTM_GEN_NEW, len(pairs)
    assert equal == len(pairs), (toks["cuda"], toks["cpu"])
    return {"equal": equal, "tokens": len(pairs)}


def fwd_cost(model, xb, label: str, card: str) -> dict:
    """One bucket forward of ``model`` on ``xb``: its peak allocation over
    the memory held before it, and its device busy ms by the profiler."""
    import torch

    fwd = model.forward_compiled(int(xb[0].shape[0]))
    free_garbage()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fwd(model._params, xb)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    busy = kernel_breakdown(lambda: fwd(model._params, xb), 3, card,
                            what=f"{label} forward")
    return {"busy_ms": sum(t for _, t in busy) / 3 / 1e3 if busy else None,
            "peak_bytes": peak, "resident_bytes": base}


def bert_quantized_phase(ft, counters, card: str) -> dict:
    """Serve BERT-base with int8 weights (``serve_quantize="int8"``)
    through ServingEngine: the resident bytes against the quantizer's
    report, the served rows against the quantized predict (bit-equal)
    and the bf16 model's, the kernels' launches a dispatch, the
    quantized forward's device time and peak memory beside the bf16
    one's, the training verbs refused and a tampered report refused at
    warm-up.  Returns the kernels' launches during the serving run."""
    import numpy as np
    import torch
    from flexflow_tpu_torch.models import build_transformer

    fwd_k, bwd_k, ln_k = counters
    free_garbage()
    cfg = ft.FFConfig(batch_size=BERT_BATCH, compute_dtype="bfloat16",
                      seed=SEED, serve_quantize="int8")
    model, _, _ = build_transformer(cfg, **BERT)   # on cuda
    model.compile()
    model.init_layers(seed=SEED)
    rng = np.random.default_rng(SEED + 2)
    seq, vocab = BERT["seq_len"], BERT["vocab_size"]
    reqs = [[rng.integers(0, vocab, (BERT_BATCH, seq)).astype(np.int32)
             for _ in range(QUANT_REQUESTS)] for _ in range(2)]
    xs = np.concatenate([x for r in reqs for x in r])
    base = model.predict(xs, batch_size=BERT_BATCH)
    xb = model._to_device((xs[:BERT_BATCH],))
    bf16 = fwd_cost(model, xb, "bf16", card)
    model._fwd_compiled = {}
    free_garbage()
    before = torch.cuda.memory_allocated()
    rep = model.quantize_weights("int8")
    free_garbage()
    after = torch.cuda.memory_allocated()
    drop, want = before - after, rep["bytes_before"] - rep["bytes_after"]
    print(f"bert int8: {len(rep['weights'])} Linear kernels quantized, "
          f"report bytes {rep['bytes_before']} -> {rep['bytes_after']} "
          f"(drop {want}); memory_allocated {before} -> {after} (drop "
          f"{drop}, {100 * (drop - want) / want:+.4f}% of the report's); "
          f"max_abs_err {rep['max_abs_err']:.4g} <= bound "
          f"{rep['error_bound']:.4g}: {rep['bound_ok']} [{card}]")
    assert abs(drop - want) <= QUANT_DROP_TOL * want, (drop, want)
    assert rep["bound_ok"] and all(
        model._params[r["weight"]].dtype == torch.int8
        for r in rep["weights"])
    engine = ft.ServingEngine(model, max_batch=BERT_BATCH)
    results = [[None] * QUANT_REQUESTS for _ in reqs]

    def producer(t: int) -> None:
        futs = [engine.submit(x) for x in reqs[t]]
        for i, f in enumerate(futs):
            results[t][i] = f.result(timeout=300)

    reset_counts(*counters)
    with engine:
        threads = [threading.Thread(target=producer, args=(t,))
                   for t in range(len(reqs))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
            assert not th.is_alive(), "producer thread did not finish"
    stats = engine.stats()
    launches = {"fwd": fwd_k.launches, "bwd": bwd_k.launches,
                "ln": ln_k.launches}
    disp, layers = stats["dispatches"], BERT["num_layers"]
    assert stats["quantize"] == "int8" and stats["errors"] == 0, stats
    assert disp > 0 and launches == {"fwd": layers * disp, "bwd": 0,
                                     "ln": 2 * layers * disp}, (launches,
                                                                stats)
    ys = np.concatenate([y for r in results for y in r])
    qpred = model.predict(xs, batch_size=BERT_BATCH)
    assert np.isfinite(ys).all(), "non-finite outputs"
    assert np.array_equal(ys, qpred), float(np.abs(ys - qpred).max())
    dev = float(np.abs(ys - base).max())
    print(f"bert int8 serve: {len(xs)} rows in {disp} dispatches, served "
          f"== quantized predict (bit-equal): True; max abs deviation "
          f"from the bf16 model on the same rows {dev:.4g} (softmax "
          f"outputs); flash forward launches {launches['fwd']} (= "
          f"{layers} x dispatches), layernorm {launches['ln']} (= "
          f"{2 * layers} x dispatches), flash backward {launches['bwd']} "
          f"[{card}]")
    quant = fwd_cost(model, xb, "int8", card)
    print(f"bert forward at batch {BERT_BATCH}: bf16 {bf16['busy_ms']} ms "
          f"busy, peak {bf16['peak_bytes'] / 2**20:.1f} MiB over "
          f"{bf16['resident_bytes'] / 2**20:.1f} resident; int8 weights "
          f"{quant['busy_ms']} ms busy, peak "
          f"{quant['peak_bytes'] / 2**20:.1f} MiB over "
          f"{quant['resident_bytes'] / 2**20:.1f} resident (each int8 "
          f"kernel is cast to a float32 copy for its product) [{card}]")
    refused = []
    y = np.zeros((BERT_BATCH, 1), np.int32)
    for verb, call in (
            ("fit", lambda: model.fit(xs[:BERT_BATCH], y, epochs=1,
                                      verbose=False)),
            ("train_batch", lambda: model.train_batch(xs[:BERT_BATCH], y)),
            ("evaluate", lambda: model.evaluate(xs[:BERT_BATCH], y)),
            ("save_checkpoint", lambda: model.save_checkpoint(
                os.path.join(HERE, "build", "refused.npz")))):
        try:
            call()
        except RuntimeError as e:
            assert "quantized" in str(e), e
            refused.append(verb)
    assert refused == ["fit", "train_batch", "evaluate",
                       "save_checkpoint"], refused
    saved = model._quant_report
    model._quant_report = dict(saved, bound_ok=False, max_abs_err=1.0,
                               error_bound=0.1)
    try:
        ft.ServingEngine(model, max_batch=BERT_BATCH)
        raise AssertionError("a violated quality bound was served")
    except RuntimeError as e:
        assert "quality bound" in str(e), e
    finally:
        model._quant_report = saved
    print(f"bert int8 guards: {', '.join(refused)} raise RuntimeError on "
          f"the card; a tampered report fails the warm-up [{card}]")
    del model, engine, xb
    free_garbage()
    torch.cuda.empty_cache()
    return {"fwd": launches["fwd"], "ln": launches["ln"],
            "bytes": {"report_drop": want, "allocated_drop": drop},
            "forward": {"bf16": bf16, "int8": quant}, "deviation": dev}


def spec_ln_checks(cuda_norm) -> list:
    """The LayerNorm kernel at the verify windows' (GEN_SLOTS, gamma,
    d) rows, bf16 in, both output forms, against its plain version, and
    timed."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    d = GPT2["d_model"]
    rows = []
    for g in sorted({2, SPEC_GAMMA}):
        x = (3 * torch.randn((GEN_SLOTS, g, d), generator=gen,
                             device="cuda") + 1).to(torch.bfloat16)
        scale = torch.randn(d, generator=gen, device="cuda")
        bias = torch.randn(d, generator=gen, device="cuda")
        err = ln_check(cuda_norm, x, None, scale, bias, " (verify window)")
        rows += ln_timing_rows(cuda_norm, x, scale, bias,
                               path="speculative", max_abs_err=err)
    return rows


def spec_model(ft, arch: dict, dtype: str, seed: int):
    """A causal LM at ``arch``'s widths on the card with the generation
    phase's engine settings."""
    cfg = ft.FFConfig(batch_size=GEN_CHECKED[0], compute_dtype=dtype,
                      seed=seed)
    cfg.serve_kv_page = GEN_PAGE
    cfg.serve_prefix_cache = "on"
    cfg.serve_prefill_chunk = GEN_CHUNK
    model, _, logits = ft.build_transformer_lm(cfg, **arch)
    model.compile(final_tensor=logits)
    model.init_layers(seed=seed)
    return model


def gap_capture(eng) -> dict:
    """The top-2 logit gap of every row the running engine decides for
    each stream (keyed by ``id(stream)``; the final prefill chunk's last
    position, then each decode step's), kept on the device.  Undone by
    deleting the two attributes from ``eng._decoder``."""
    rec = {}
    dec = eng._decoder
    walk_prefill, walk_decode = dec._walk_prefill, dec._walk_decode

    def prefill(params, caches, tokens, row, slot, start, length):
        out = walk_prefill(params, caches, tokens, row, slot, start, length)
        st = eng._slots_state[slot]
        if st is not None:      # None: the warm-up's empty chunk
            top = out.float().topk(2).values
            rec[id(st.stream)] = [top[0] - top[1]]
        return out

    def decode(params, caches, tokens, pos, table, ws, wp, wr):
        out = walk_decode(params, caches, tokens, pos, table, ws, wp, wr)
        top = out.float().topk(2, dim=-1).values
        gap = top[:, 0] - top[:, 1]
        for i, s in enumerate(eng._slots_state):
            if s is not None and not s.prefilling:
                rec[id(s.stream)].append(gap[i])
        return out

    dec._walk_prefill, dec._walk_decode = prefill, decode
    return rec


def ln_ops(model) -> int:
    return sum(1 for op in model.layers
               if op.op_type.value == "layernorm")


def verify_shifted(eng) -> None:
    """Break the engine's greedy verify on purpose: every window is
    walked at positions one on from the slot's (the control of the bf16
    divergence check)."""
    dec = eng._decoder
    make = dec.verify_fn

    def verify_fn(width, sampled=False):
        assert not sampled
        fn = make(width)

        def shifted(params, caches, first, d, pos, *rest):
            return fn(params, caches, first, d, pos + 1, *rest)
        return shifted

    dec.verify_fn = verify_fn


def spec_run(ft, model, prompts, counters, ntok: int, sampling=None,
             capture=False, tamper=None, **kw) -> dict:
    """``prompts`` through a fresh GenerationEngine (queued before it
    starts, so every run has the same schedule), ``ntok`` tokens each;
    the stats after the dispatcher stops, the kernels' launches during
    the run (counted from 0 after the warm-up) against the dispatches'
    reckoning, and the memory the engine held at start and after.
    ``tamper(engine)``, when given, runs before the engine starts."""
    import torch

    fwd_k, bwd_k, ln_k = counters
    eng = ft.GenerationEngine(model, slots=GEN_SLOTS,
                              metrics_window_s=3600, **kw)
    streams = [eng.submit(p, max_new_tokens=ntok,
                          sampling=None if sampling is None else sampling[i])
               for i, p in enumerate(prompts)]
    rec = gap_capture(eng) if capture else None
    if tamper is not None:
        tamper(eng)
    warmup = eng._warmup

    def warmup_then_count():
        # the dispatcher serves the queued prompts as soon as start()
        # returns, so the counts start at the warm-up's end, before its
        # thread exists
        warmup()
        torch.cuda.synchronize()
        reset_counts(*counters)

    eng._warmup = warmup_then_count
    free_garbage()
    eng.start()
    torch.cuda.synchronize()
    started = torch.cuda.memory_allocated()
    draft_bytes = eng.draft_kv_cache_bytes
    draft_alloc = (sum(t.numel() * t.element_size()
                       for c in eng._draft_caches.values()
                       for t in c.values())
                   if eng._draft_caches is not None else 0)
    t0 = time.perf_counter()
    try:
        outs = [s.result(timeout=900).tolist() for s in streams]
        wall = time.perf_counter() - t0
    finally:
        eng.stop()
        if capture:
            del eng._decoder._walk_prefill, eng._decoder._walk_decode
    snap = eng.stats()
    free_garbage()
    ended = torch.cuda.memory_allocated()
    gaps = ({id_: torch.stack(v).cpu() for id_, v in rec.items()}
            if capture else None)
    # LayerNorm ops a walk of the target and of the draft: one kernel
    # launch each
    lns = ln_ops(model)
    dlns = 0 if eng.draft_model is None else ln_ops(eng.draft_model)
    want_ln = (lns * (eng._n_steps + eng._chunks_total)
               + dlns * (eng._draft_steps + eng._draft_prefills))
    launches = {"fwd": fwd_k.launches, "bwd": bwd_k.launches,
                "ln": ln_k.launches}
    assert snap["errors"] == 0 and snap["requests"] == len(prompts), snap
    assert launches == {"fwd": 0, "bwd": 0, "ln": want_ln}, (launches,
                                                             want_ln)
    out = {"outs": outs, "snap": snap, "wall": wall,
           "tokens": sum(len(o) for o in outs), "launches": launches,
           "rounds": snap["draft_dispatches"], "steps": eng._n_steps,
           "draft_steps": eng._draft_steps, "chunks": eng._chunks_total,
           "draft_prefills": eng._draft_prefills, "draft_lns": dlns,
           "lns": lns, "mem_started": started, "mem_ended": ended,
           "draft_bytes": draft_bytes, "draft_alloc": draft_alloc,
           "gaps": gaps, "ids": [id(s) for s in streams]}
    del eng, streams
    free_garbage()
    return out


def spec_report(label: str, r: dict, card: str) -> None:
    s = r["snap"]
    per_round = ""
    if r["rounds"]:
        per_round = (f"; layernorm a round {r['lns']} (verify) + "
                     f"{r['draft_lns']} x gamma (draft steps: "
                     f"{r['draft_steps']} over {r['rounds']} rounds, "
                     f"gamma {r['draft_steps'] / r['rounds']:.3f} on "
                     f"average)")
    print(f"speculative {label}: {len(r['outs'])} requests, {r['tokens']} "
          f"tokens in {r['wall']:.3f}s: {r['tokens'] / r['wall']:.1f} "
          f"tokens/s; TPOT p50 {s['tpot_p50_ms']} ms p99 "
          f"{s['tpot_p99_ms']} ms (a round under speculation); spec "
          f"{s['spec']}, gamma {s['spec_gamma']} ({s['spec_policy']}), "
          f"accept rate {s['accept_rate']} ({s['spec_accepted_tokens']} of "
          f"{s['spec_proposed_tokens']}), draft dispatches "
          f"{s['draft_dispatches']}, spec_fallbacks {s['spec_fallbacks']}; "
          f"{r['steps']} rounds or steps, {r['chunks']} chunks, "
          f"{r['draft_prefills']} draft prefills; layernorm launches "
          f"{r['launches']['ln']} = {r['lns']} x (steps + chunks) + "
          f"{r['draft_lns']} x (draft steps + draft prefills)"
          f"{per_round}; flash launches {r['launches']['fwd']} [{card}]")


def spec_divergence(plain: dict, spec: dict) -> list:
    """The streams whose speculative tokens leave the plain run's, each
    with its first divergence and the plain run's top-2 logit gap there
    (the check holds it under GEN_LOGIT_TOL: a rounding flip, not a
    fault)."""
    diverged = []
    for i, (a, b) in enumerate(zip(plain["outs"], spec["outs"])):
        j = next((k for k, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if j is None:
            continue
        gap = float(plain["gaps"][plain["ids"][i]][j])
        diverged.append({"stream": i, "at": j, "gap": gap})
    return diverged


def gap_quantiles(plain: dict) -> dict:
    """The plain run's top-2 logit gaps over every position it decided:
    quantiles, and the share under GEN_LOGIT_TOL (the chance that the
    divergence check passes a stream that a fault sends off at a random
    position)."""
    import torch

    g = torch.cat([plain["gaps"][i] for i in plain["ids"]]).double()
    qs = (0.01, 0.05, 0.1, 0.25, 0.5, 0.75, 0.9)
    vals = torch.quantile(g, torch.tensor(qs, dtype=g.dtype)).tolist()
    return {"positions": g.numel(),
            "quantiles": {str(q): v for q, v in zip(qs, vals)},
            "share_under_tol": float((g < GEN_LOGIT_TOL).double().mean())}


def spec_sync_check(model, draft) -> None:
    """One full-width round, the draft's SPEC_GAMMA steps then the
    verify, enqueued under ``set_sync_debug_mode("error")`` (every write
    through the sentinel); the round's one fetch after it."""
    import numpy as np
    import torch
    from flexflow_tpu_torch.serving.generation import GraphDecoder

    dec = GraphDecoder.for_model(model, GEN_SLOTS, GPT2["seq_len"])
    ddec = GraphDecoder.for_model(draft, GEN_SLOTS, GPT2["seq_len"],
                                  page_size=dec.page_size,
                                  num_pages=dec.num_pages)
    caches, dcaches = dec.init_cache(), ddec.init_cache()
    g, no = SPEC_GAMMA, dec.num_pages
    table = np.full((GEN_SLOTS, dec.pages_per_slot), no, np.int32)
    first = np.arange(GEN_SLOTS, dtype=np.int32)
    pos = np.full((GEN_SLOTS,), 100, np.int32)
    wp, wr = np.full((g, GEN_SLOTS), no, np.int32), np.zeros(
        (g, GEN_SLOTS), np.int32)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        d = ddec.draft_fn(g)(draft._params, dcaches, first, pos, table, wp,
                             wr)
        n_acc, out = dec.verify_fn(g)(model._params, caches, first, d, pos,
                                      table, wp.T.copy(), wr.T.copy())
    finally:
        torch.cuda.set_sync_debug_mode("default")
    host = torch.cat([n_acc[:, None], out], 1).cpu()
    assert host.shape == (GEN_SLOTS, 1 + g)
    del caches, dcaches


SPEC_DRAFT_RUNS = ("self", "distil", "self sampled", "self sampled replay",
                   "distil sampled")


def spec_generation_phase(ft, counters, card) -> dict:
    """Speculative decoding at GPT-2 small's widths (see the module
    docstring); returns the kernel rows and launch counts."""
    import torch
    import numpy as np
    from flexflow_tpu_torch.ops import cuda_norm

    ln_rows = spec_ln_checks(cuda_norm)
    free_garbage()
    model = spec_model(ft, GPT2, "bfloat16", SEED)
    distil = spec_model(ft, DISTILGPT2, "bfloat16", SEED + 1)
    spec_sync_check(model, model)
    print(f"speculative round (draft {SPEC_GAMMA} steps + verify, "
          f"{GEN_SLOTS} slots, full width) enqueued with no host sync: "
          f"True [{card}]")
    traffic = gen_traffic(np.random.default_rng(SEED), GPT2["vocab_size"])
    prompts = traffic[:SPEC_REQUESTS]
    sp = [ft.SamplingParams(seed=i, **GEN_SAMPLING)
          for i in range(SPEC_SAMPLED)]
    sprompts = traffic[:SPEC_SAMPLED]
    runs = {}
    runs["plain"] = spec_run(ft, model, prompts, counters, GEN_NEW)
    # the same run again with each step's top-2 gap captured (a topk a
    # step, so not the timed run); the same schedule gives the same
    # tokens
    runs["plain captured"] = spec_run(ft, model, prompts, counters, GEN_NEW,
                                      capture=True)
    assert runs["plain captured"]["outs"] == runs["plain"]["outs"]
    runs["self"] = spec_run(ft, model, prompts, counters, GEN_NEW,
                            draft_model=model, spec_gamma=SPEC_GAMMA)
    runs["distil"] = spec_run(ft, model, prompts, counters, GEN_NEW,
                              draft_model=distil, spec_policy="adaptive",
                              spec_gamma_max=SPEC_GAMMA)
    runs["plain sampled"] = spec_run(ft, model, sprompts, counters, GEN_NEW,
                                     sampling=sp)
    runs["self sampled"] = spec_run(ft, model, sprompts, counters, GEN_NEW,
                                    sampling=sp, draft_model=model,
                                    spec_gamma=SPEC_GAMMA)
    runs["self sampled replay"] = spec_run(
        ft, model, sprompts, counters, GEN_NEW, sampling=sp,
        draft_model=model, spec_gamma=SPEC_GAMMA)
    runs["distil sampled"] = spec_run(
        ft, model, sprompts, counters, GEN_NEW, sampling=sp,
        draft_model=distil, spec_policy="adaptive",
        spec_gamma_max=SPEC_GAMMA)
    for label, r in runs.items():
        spec_report(label, r, card)
    # the control: the same check on a deliberately wrong verify must
    # fail
    control = spec_run(ft, model, prompts, counters, SPEC_CONTROL_NEW,
                       tamper=verify_shifted, draft_model=model,
                       spec_gamma=SPEC_GAMMA)
    spec_report("self, verify one position off (control)", control, card)
    gaps = gap_quantiles(runs["plain captured"])
    print(f"speculative plain top-2 logit gaps (bf16) over "
          f"{gaps['positions']} decided positions: quantiles "
          f"{json.dumps(gaps['quantiles'])}; share under {GEN_LOGIT_TOL}: "
          f"{gaps['share_under_tol']} [{card}]")
    checks = {}
    for label, r in (("self", runs["self"]), ("distil", runs["distil"]),
                     ("control", control)):
        div = spec_divergence(runs["plain captured"], r)
        checks[label] = div
        print(f"speculative {label} greedy tokens vs plain (bf16): "
              f"{len(div)} of {len(prompts)} streams diverge; at "
              f"{sum(d['gap'] >= GEN_LOGIT_TOL for d in div)} of them the "
              f"plain top-2 gap is {GEN_LOGIT_TOL} or more; check passes: "
              f"{all(d['gap'] < GEN_LOGIT_TOL for d in div)} "
              f"{json.dumps(div)} [{card}]")
    for label in ("self", "distil"):
        r = runs[label]
        assert r["draft_alloc"] == r["draft_bytes"] > 0, r
    dr = runs["distil"]
    print(f"speculative distil draft pool: {dr['draft_alloc']} bytes "
          f"allocated = draft_kv_cache_bytes {dr['draft_bytes']}; "
          f"memory_allocated at start {dr['mem_started']}, after the "
          f"demotion and stop {dr['mem_ended']}: "
          f"{dr['mem_started'] - dr['mem_ended']} bytes freed [{card}]")
    same = runs["self sampled"]["outs"] == runs["self sampled replay"]["outs"]
    print(f"speculative sampled replay: {SPEC_SAMPLED} x {GEN_NEW} tokens "
          f"in two fresh engines, the same tokens: {same} [{card}]")
    del model, distil
    free_garbage()
    torch.cuda.empty_cache()
    f32 = spec_f32_check(ft, traffic, counters, card)
    assert same
    for label in ("self", "distil"):
        assert all(d["gap"] < GEN_LOGIT_TOL for d in checks[label]), \
            checks[label]
    assert any(d["gap"] >= GEN_LOGIT_TOL for d in checks["control"]), \
        checks["control"]
    assert runs["self"]["snap"]["spec"] == "on"
    assert runs["distil"]["snap"]["spec"] == "fallback"
    assert runs["distil"]["snap"]["spec_fallbacks"] == 1
    assert dr["mem_started"] - dr["mem_ended"] >= dr["draft_bytes"], dr
    # the launches by path: the bf16 runs with a draft, the plain bf16
    # runs beside them, and the float32 twin (a check at reduced depth)
    paths = {"speculative": [runs[k] for k in SPEC_DRAFT_RUNS],
             "speculative_plain": [runs[k] for k in runs
                                   if k not in SPEC_DRAFT_RUNS],
             "speculative_f32_check": f32.pop("runs")}
    return {"ln": {p: sum(r["launches"]["ln"] for r in rs)
                   for p, rs in paths.items()},
            "fwd": {p: sum(r["launches"]["fwd"] for r in rs)
                    for p, rs in paths.items()},
            "ln_rows": ln_rows, "f32": f32, "gaps": gaps,
            "control": checks["control"],
            "runs": {k: {kk: v for kk, v in r.items()
                         if kk not in ("outs", "gaps", "ids")}
                     for k, r in runs.items()}}


def spec_f32_check(ft, traffic, counters, card) -> dict:
    """The float32 twin at SPEC_F32_LAYERS layers (the DistilGPT2 draft
    at one): plain, self-draft and adaptive DistilGPT2-draft greedy
    tokens, every one equal."""
    arch = dict(GPT2, num_layers=SPEC_F32_LAYERS)
    model = spec_model(ft, arch, "float32", SEED)
    distil = spec_model(ft, dict(DISTILGPT2, num_layers=1), "float32",
                        SEED + 1)
    prompts = traffic[:SPEC_F32_REQUESTS]
    runs = {"plain": spec_run(ft, model, prompts, counters, SPEC_F32_NEW),
            "self": spec_run(ft, model, prompts, counters, SPEC_F32_NEW,
                             draft_model=model, spec_gamma=SPEC_GAMMA),
            "distil": spec_run(ft, model, prompts, counters, SPEC_F32_NEW,
                               draft_model=distil, spec_policy="adaptive",
                               spec_gamma_max=SPEC_GAMMA)}
    equal = {k: runs[k]["outs"] == runs["plain"]["outs"]
             for k in ("self", "distil")}
    acc = {k: runs[k]["snap"]["accept_rate"] for k in ("self", "distil")}
    print(f"speculative float32 twin ({SPEC_F32_LAYERS} layers, draft "
          f"DistilGPT2 widths at 1 layer): {SPEC_F32_REQUESTS} x "
          f"{SPEC_F32_NEW} greedy tokens equal to plain decode: "
          f"{json.dumps(equal)}; accept rates {json.dumps(acc)} [{card}]")
    del model, distil
    free_garbage()
    assert all(equal.values()), {k: (runs[k]["outs"], runs["plain"]["outs"])
                                 for k in equal}
    return {"equal": equal, "accept_rate": acc,
            "runs": [{"launches": r["launches"]} for r in runs.values()]}


def colo_run(ft, model, prompts, ntok: int, prefix_cache: str) -> dict:
    """``prompts`` x ``ntok`` greedy tokens through one co-located engine
    of the disaggregated pair's settings, all submitted at once."""
    eng = ft.GenerationEngine(model, slots=GEN_SLOTS, page_size=GEN_PAGE,
                              prefill_chunk=GEN_CHUNK,
                              prefix_cache=prefix_cache, stats_every=0,
                              metrics_window_s=3600)
    with eng:
        t0 = time.perf_counter()
        streams = [eng.submit(p, max_new_tokens=ntok) for p in prompts]
        outs = [s.result(timeout=900).tolist() for s in streams]
        wall = time.perf_counter() - t0
    return {"tokens": outs, "wall": wall, "stats": eng.stats(),
            "ttft": [s.ttft for s in streams]}


def disagg_run(ft, model, layers: int, prompts, ntok: int,
               prefix_cache: str, counters, pace_s: float = None) -> dict:
    """The same prompts through the port's ``build_disagg`` pair: every
    stream prefills on the prefill engine and decodes on the decode
    engine after its KV pages migrate; the model has ``layers``
    transformer blocks.  ``pace_s`` is the prefill
    host's pacing (``build_disagg``'s default when None).  Returns the
    tokens, the router's and both engines' stats, the migration costs
    and the kernels' launches of the run with each engine's
    dispatches."""
    from flexflow_tpu_torch.serving.cluster import build_disagg
    from flexflow_tpu_torch.serving.cluster.bench import _reconciled

    fwd_k, bwd_k, ln_k = counters
    kw = {} if pace_s is None else {"pf_pace_s": pace_s}
    # the page size is the model's serve_kv_page (spec_model: GEN_PAGE)
    router, fleets, (pf, dc) = build_disagg(
        model, GEN_SLOTS, model.input_tensors[0].shape[1], GEN_CHUNK,
        prefix_cache=prefix_cache, **kw)
    try:
        reset_counts(*counters)
        t0 = time.perf_counter()
        streams = [router.submit("lm", p, max_new_tokens=ntok)
                   for p in prompts]
        outs = [s.result(timeout=900).tolist() for s in streams]
        wall = time.perf_counter() - t0
        if prefix_cache == "off":
            deadline = time.monotonic() + 60
            while pf._pool.pages_in_use or dc._pool.pages_in_use:
                assert time.monotonic() < deadline, "pools never drained"
                time.sleep(0.005)
        rstats = router.stats()
    finally:
        router.stop()
        for f in fleets:
            f.stop()
    launches = {"ln": ln_k.launches, "fwd": fwd_k.launches,
                "bwd": bwd_k.launches}
    snaps = [pf.stats(), dc.stats()]
    assert _reconciled(snaps), snaps
    assert snaps[0]["errors"] == 0 and snaps[1]["errors"] == 0, snaps
    disp = {"prefill": pf._n_steps + pf._chunks_total,
            "decode": dc._n_steps + dc._chunks_total}
    # the paged attention is plain torch: no flash launch on either engine
    assert launches["fwd"] == launches["bwd"] == 0, launches
    assert launches["ln"] == 2 * layers * sum(disp.values()), \
        (launches, disp)
    return {"tokens": outs, "wall": wall, "router": rstats,
            "stats": snaps, "engines": (pf, dc),
            "ttft": [s.ttft for s in streams], "launches": launches,
            "dispatches": disp, "pools": (pf._pool.pages_in_use,
                                          dc._pool.pages_in_use)}


def pct(xs, q):
    from flexflow_tpu_torch.serving.metrics import quantiles

    return quantiles(xs, (q,))[q]


def host_copies(fn):
    """Run ``fn()``; returns its result and every copy between the host
    and a card that its ops issued, as ``{"DtoH": [bytes, ...], "HtoD":
    [...]}``.  The copies are seen at PyTorch's dispatcher (a
    ``TorchDispatchMode``), not by the profiler: on an H100 the
    profiler's device copies came and went between runs of one process
    (a device-to-host copy recorded in one run and not in the next).
    An op counts as a copy when a tensor it reads lies on one side and
    what it returns on the other; a ``.item()`` of a card's tensor is a
    device-to-host copy.  An upload made below the dispatcher, such as
    ``torch.tensor`` of a Python list onto the card, is not seen."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    copies = {"DtoH": [], "HtoD": []}
    scalar = torch.ops.aten._local_scalar_dense.default

    def tensors(tree):
        return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]

    class Copies(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            ins = tensors((args, kwargs))
            if func is scalar and ins[0].device.type != "cpu":
                copies["DtoH"].append(ins[0].element_size())
                return out
            sides = {t.device.type == "cpu" for t in ins if t.dim() > 0}
            for t in tensors(out):
                to_host = t.device.type == "cpu"
                if (not to_host) in sides:
                    copies["DtoH" if to_host else "HtoD"].append(
                        t.numel() * t.element_size())
            return out

    with Copies():
        result = fn()
    return result, copies


def page_copy_checks(pf, dc, npages: int, card: str) -> dict:
    """One chain of ``npages`` pages of the prefill engine's pool through
    ``export_pages``, ``pages_to_device`` and ``import_pages`` into other
    pages of the decode engine's pool: the imported rows read back
    bit-equal to the exported ones; the chain crosses to the host and
    back in one copy each way, of the chain's bytes (:func:`host_copies`;
    the index arrays' uploads are not seen); each leg is timed over 10
    runs (p50 and p99 ms, GB/s)."""
    import torch

    from flexflow_tpu_torch.serving.generation.pages import (
        export_pages, import_pages, pages_to_device)

    src = list(range(npages))
    dst = list(range(pf.num_pages - npages, pf.num_pages))
    nbytes = npages * pf.kv_plan["page_bytes"]

    def once():
        host = export_pages(pf._caches, src, pf.num_pages)
        dev = pages_to_device(host, dc.device)
        import_pages(dc._caches, dev, dst)
        return host

    once()
    torch.cuda.synchronize()
    _, copies = host_copies(once)
    torch.cuda.synchronize()
    same = all(torch.equal(pf._caches[n][leaf][src],
                           dc._caches[n][leaf][dst])
               for n in pf._caches for leaf in pf._caches[n])
    times = {"export": [], "to_device": [], "import": []}
    for _ in range(10):
        t0 = time.perf_counter()
        host = export_pages(pf._caches, src, pf.num_pages)
        t1 = time.perf_counter()
        dev = pages_to_device(host, dc.device)
        t2 = time.perf_counter()
        import_pages(dc._caches, dev, dst)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        for k, a, b in (("export", t0, t1), ("to_device", t1, t2),
                        ("import", t2, t3)):
            times[k].append((b - a) * 1e3)
    legs = {k: {"p50_ms": round(pct(v, 0.5), 4),
                "p99_ms": round(pct(v, 0.99), 4),
                "GB_per_s": round(nbytes / pct(v, 0.5) / 1e6, 3)}
            for k, v in times.items()}
    print(f"migration legs at {npages} pages ({nbytes} bytes): "
          f"{json.dumps(legs)}; copies in one migration (bytes each, at "
          f"the dispatcher) {json.dumps(copies)}; imported pages "
          f"bit-equal to the exported: {same} [{card}]")
    return {"same": same, "copies": copies, "legs": legs,
            "bytes": nbytes}


def disagg_pace_default() -> float:
    """``build_disagg``'s prefill pacing when the caller names none."""
    import inspect

    from flexflow_tpu_torch.serving.cluster import build_disagg

    return inspect.signature(build_disagg).parameters["pf_pace_s"].default


def pacing_timing(run) -> dict:
    ds = run["stats"][1]
    return {"wall_s": run["wall"], "ttft_p50_ms": pct(run["ttft"], 0.5) * 1e3,
            "tpot_p50_ms": ds["tpot_p50_ms"], "tpot_p95_ms": ds["tpot_p95_ms"]}


def pacing_pairs(ft, model, layers, prompts, want, counters, card,
                 pairs: int, first: dict = None,
                 ntok: int = GEN_NEW) -> dict:
    """The prefill host's pacing: ``build_disagg``'s default (A) against
    the other of 0 and 0.002 s (B), prefix cache off, ``pairs`` pairs in
    the order A B, B A, A B, ...; ``first`` is the timing of an A run
    already made, the first pair's; ``ntok`` tokens a request.  Every
    run's tokens must equal
    ``want``.  Prints each metric's runs, the pairs B won (lower is
    better), both arms' medians and A's quartile distance; returns them
    with the runs' launches."""
    import numpy as np

    pace_a = disagg_pace_default()
    pace_b = 0.0 if pace_a else 0.002
    order = [p for i in range(pairs)
             for p in ((pace_a, pace_b) if i % 2 == 0 else (pace_b, pace_a))]
    arms = {pace_a: [], pace_b: []}
    if first is not None:
        arms[pace_a].append(first)
        order = order[1:]
    launches = {"ln": 0, "fwd": 0}
    for pace in order:
        run = disagg_run(ft, model, layers, prompts, ntok, "off",
                         counters, pace_s=pace)
        assert run["tokens"] == want
        for k in launches:
            launches[k] += run["launches"][k]
        arms[pace].append(pacing_timing(run))
        del run
        free_garbage()
    summary = {}
    for m in ("wall_s", "ttft_p50_ms", "tpot_p50_ms", "tpot_p95_ms"):
        a = [r[m] for r in arms[pace_a]]
        b = [r[m] for r in arms[pace_b]]
        q1, q3 = np.percentile(a, [25, 75])
        summary[m] = {"b_won": sum(y < x for x, y in zip(a, b)),
                      "pairs": pairs, "median_a": float(np.median(a)),
                      "median_b": float(np.median(b)),
                      "iqr_a": float(q3 - q1), "a": a, "b": b}
    print(f"disagg prefill pacing (prefix off, {pairs} pairs, A = "
          f"{pace_a} s, B = {pace_b} s; pairs B won, medians A / B, A's "
          f"quartile distance): "
          + "; ".join(f"{m} {v['b_won']} of {pairs}, {v['median_a']:.3f} / "
                      f"{v['median_b']:.3f}, {v['iqr_a']:.3f}"
                      for m, v in summary.items())
          + f"; runs {json.dumps({m: [v['a'], v['b']] for m, v in summary.items()})}"
          f" [{card}]")
    return {"pace_a": pace_a, "pace_b": pace_b, "summary": summary,
            "launches": launches}


def disagg_pacing_phase(ft, counters, card, pairs: int = 10) -> dict:
    """The pacing arms alone, ``pairs`` pairs after one run that is not
    kept (the first run of a process is the slowest)."""
    import numpy as np

    model = spec_model(ft, GPT2, "bfloat16", SEED)
    prompts = gen_traffic(np.random.default_rng(SEED),
                          GPT2["vocab_size"])[:DISAGG_REQUESTS]
    want = colo_run(ft, model, prompts, GEN_NEW, "off")["tokens"]
    disagg_run(ft, model, GPT2["num_layers"], prompts, GEN_NEW, "off",
               counters)
    free_garbage()
    return pacing_pairs(ft, model, GPT2["num_layers"], prompts, want,
                        counters, card, pairs)


def disagg_phase(ft, counters, card) -> dict:
    """Serve GPT-2 small's widths disaggregated (see the module
    docstring); returns the kernels' launches by path, each read from
    its own runs: ``disagg`` (the two bf16 runs, prefix cache off and
    on), ``disagg_pacing`` (the pacing arms), ``disagg_fault`` (the
    ``migrate_fail_at:1`` run) and ``disagg_f32_check`` (the float32
    twin)."""
    import math

    import numpy as np

    from flexflow_tpu_torch import faults
    from flexflow_tpu_torch.fflogger import capture_events

    free_garbage()
    model = spec_model(ft, GPT2, "bfloat16", SEED)
    prompts = gen_traffic(np.random.default_rng(SEED),
                          GPT2["vocab_size"])[:DISAGG_REQUESTS]
    layers = GPT2["num_layers"]
    # only counts and tokens leave a run: an engine kept alive would hold
    # its KV pools (604 MB each) through every later phase's peak
    out = {"ln": {}, "fwd": {}}

    def count(path, run):
        for k in ("ln", "fwd"):
            out[k][path] = out[k].get(path, 0) + run["launches"][k]

    pace0 = disagg_pace_default()
    for pc in ("off", "on"):
        colo = colo_run(ft, model, prompts, DISAGG_NEW, pc)
        dis = disagg_run(ft, model, layers, prompts, DISAGG_NEW, pc,
                         counters)
        count("disagg", dis)
        pf, dc = dis["engines"]
        r = dis["router"]
        page_bytes = pf.kv_plan["page_bytes"]
        pages = [math.ceil(len(p) / GEN_PAGE) for p in prompts]
        want_bytes = sum(pages) * DISAGG_PAGE_BYTES
        equal = dis["tokens"] == colo["tokens"]
        first_diff = next((i for i, (a, b) in enumerate(
            zip(dis["tokens"], colo["tokens"])) if a != b), None)
        mig_bytes = [n * page_bytes for n in pages]
        exp_ms, imp_ms = pf.migrate_export_ms, dc.migrate_import_ms
        handoff_ms = r["migrate_ms_total"] / max(1, r["migrations"])
        cs, ds = colo["stats"], dis["stats"][1]
        print(f"disagg prefix {pc}: {DISAGG_REQUESTS} requests x {DISAGG_NEW} "
              f"greedy tokens, tokens equal to the co-located engine's: "
              f"{equal} (first differing request {first_diff}); routes "
              f"{r['routes']}, migrations {r['migrations']}, migrated bytes "
              f"{r['migrated_bytes']} (sum of pages_used x "
              f"{DISAGG_PAGE_BYTES} = {want_bytes}); pools in use after "
              f"the run {dis['pools']}; prefill pacing {pace0} s; wall "
              f"{dis['wall']:.3f}s against "
              f"{colo['wall']:.3f}s co-located; TTFT p50 "
              f"{pct(dis['ttft'], 0.5) * 1e3:.1f} ms against "
              f"{pct(colo['ttft'], 0.5) * 1e3:.1f}; TPOT p50/p95 "
              f"{ds['tpot_p50_ms']}/{ds['tpot_p95_ms']} ms against "
              f"{cs['tpot_p50_ms']}/{cs['tpot_p95_ms']} [{card}]")
        print(f"disagg prefix {pc} migrations: export (gather + one "
              f"device-to-host copy) p50 {pct(exp_ms, 0.5):.3f} ms p99 "
              f"{pct(exp_ms, 0.99):.3f} ms, "
              f"{sum(mig_bytes) / sum(exp_ms) / 1e6:.3f} GB/s; handoff "
              f"(pick + host-to-device copy + queue) mean "
              f"{handoff_ms:.3f} ms, "
              f"{sum(mig_bytes) / max(1, r['migrations']) / handoff_ms / 1e6:.3f}"
              f" GB/s; import (scatter) p50 {pct(imp_ms, 0.5):.3f} ms p99 "
              f"{pct(imp_ms, 0.99):.3f} ms; bytes a migration mean "
              f"{sum(mig_bytes) / len(mig_bytes):.0f} [{card}]")
        print(f"disagg prefix {pc} launches: layernorm "
              f"{dis['launches']['ln']} = prefill engine "
              f"{dis['dispatches']['prefill']} dispatches x {2 * layers} + "
              f"decode engine {dis['dispatches']['decode']} x "
              f"{2 * layers}; flash forward {dis['launches']['fwd']}, "
              f"backward {dis['launches']['bwd']} [{card}]")
        assert page_bytes == DISAGG_PAGE_BYTES, page_bytes
        assert equal, (pc, first_diff)
        assert r["routes"] == r["migrations"] == DISAGG_REQUESTS, r
        assert r["migrated_bytes"] == want_bytes, (r, want_bytes)
        assert len(exp_ms) == len(imp_ms) == DISAGG_REQUESTS
        assert dis["stats"][0]["requests"] == 0, dis["stats"][0]
        assert dis["stats"][1]["requests"] == DISAGG_REQUESTS
        if pc == "off":
            assert dis["pools"] == (0, 0), dis["pools"]
            out["copies"] = page_copy_checks(pf, dc, 32, card)
            assert out["copies"]["same"] and out["copies"]["copies"] == {
                "DtoH": [out["copies"]["bytes"]],
                "HtoD": [out["copies"]["bytes"]]}, out["copies"]
            want = colo["tokens"]
            first = pacing_timing(dis)
        del dis, pf, dc
        free_garbage()
        if pc == "off":
            # the run above is the first of the pacing arms' pairs
            out["pacing"] = pacing_pairs(ft, model, layers, prompts, want,
                                         counters, card,
                                         DISAGG_PACING_PAIRS, first,
                                         DISAGG_NEW)
            count("disagg_pacing", out["pacing"])
    # FF_FAULT=migrate_fail_at:1: the first stream decodes co-located
    fprompts = prompts[:DISAGG_FAULT_REQUESTS]
    os.environ["FF_FAULT"] = "migrate_fail_at:1"
    faults.reset()
    try:
        with capture_events("serve") as events:
            fault = disagg_run(ft, model, layers, fprompts, DISAGG_NEW, "off",
                               counters)
    finally:
        os.environ.pop("FF_FAULT", None)
        faults.reset()
    count("disagg_fault", fault)
    health = [e for e in events if e["event"] == "serve_health"
              and e.get("component") == "migration"]
    r = fault["router"]
    print(f"disagg fault migrate_fail_at:1: {len(health)} fallback "
          f"event(s) ({[h['reason'] for h in health]}), migrations "
          f"{r['migrations']} of {r['migrate_attempts']} attempts, tokens "
          f"equal to co-located: "
          f"{fault['tokens'] == want[:DISAGG_FAULT_REQUESTS]}, errors "
          f"{[s['errors'] for s in fault['stats']]}; launches "
          f"{json.dumps(fault['launches'])} [{card}]")
    assert len(health) == 1 and health[0]["reason"] == "handoff_error"
    assert r["migrations"] == DISAGG_FAULT_REQUESTS - 1
    assert r["migrate_attempts"] == DISAGG_FAULT_REQUESTS
    assert fault["stats"][0]["requests"] == 1
    assert fault["tokens"] == want[:DISAGG_FAULT_REQUESTS]
    del fault, model
    free_garbage()
    # the float32 twin
    f32 = spec_model(ft, dict(GPT2, num_layers=DISAGG_F32_LAYERS),
                     "float32", SEED)
    fp = prompts[:DISAGG_F32_REQUESTS]
    colo = colo_run(ft, f32, fp, DISAGG_F32_NEW, "off")
    dis = disagg_run(ft, f32, DISAGG_F32_LAYERS, fp, DISAGG_F32_NEW, "off",
                     counters)
    count("disagg_f32_check", dis)
    pf, dc = dis["engines"]
    checks = page_copy_checks(pf, dc, 8, card)
    print(f"disagg float32 twin ({DISAGG_F32_LAYERS} layers): "
          f"{DISAGG_F32_REQUESTS} x {DISAGG_F32_NEW} tokens equal to the "
          f"co-located engine's: {dis['tokens'] == colo['tokens']}; "
          f"migrations {dis['router']['migrations']}; launches "
          f"{json.dumps(dis['launches'])} [{card}]")
    assert dis["tokens"] == colo["tokens"]
    assert checks["same"] and dis["router"]["migrations"] == len(fp)
    assert checks["copies"] == {"DtoH": [checks["bytes"]],
                                "HtoD": [checks["bytes"]]}, checks
    del dis, pf, dc, f32
    free_garbage()
    return out


def allocated_blocks() -> dict:
    """The caching allocator's allocated blocks, address -> (size,
    requested bytes), from ``torch.cuda.memory_snapshot()``."""
    import torch

    out = {}
    for seg in torch.cuda.memory_snapshot():
        addr = seg["address"]
        for b in seg["blocks"]:
            if b["state"] == "active_allocated":
                out[b.get("address", addr)] = (
                    b["size"], b.get("requested_size", b["size"]))
            addr += b["size"]
    return out


def fleet_phase(ft, counters, card) -> dict:
    """BERT-base and the generation LM as two tenants of one FleetEngine
    (see the module docstring); returns the kernels' launches."""
    import numpy as np
    import torch

    from flexflow_tpu_torch.models import build_transformer
    from flexflow_tpu_torch.serving.fleet import (FleetEngine, TenantSpec,
                                                  model_residency)

    fwd_k, bwd_k, ln_k = counters
    # the warm-ups below run on this thread: its cuBLAS workspace (32
    # MiB a handle and stream on an H100) must exist before the count
    # starts, or it would show as a block no tenant owns
    for dt in (torch.float32, torch.bfloat16):
        a = torch.ones((16, 16), dtype=dt, device="cuda")
        (a @ a).sum().item()
    del a
    free_garbage()
    m0 = torch.cuda.memory_allocated()
    blocks0 = allocated_blocks()
    cfg = ft.FFConfig(batch_size=BERT_BATCH, compute_dtype="bfloat16",
                      seed=SEED)
    bert, _, _ = build_transformer(cfg, **BERT)   # on cuda
    bert.compile()
    bert.init_layers(seed=SEED)
    lm = spec_model(ft, GPT2, "bfloat16", SEED)
    gen_kw = {"slots": GEN_SLOTS, "page_size": GEN_PAGE,
              "prefill_chunk": GEN_CHUNK, "prefix_cache": "off"}
    fleet = FleetEngine()
    fleet.add_engine("bert", ft.ServingEngine(bert, max_batch=BERT_BATCH,
                                              name="bert"))
    fleet.add_engine("lm", ft.GenerationEngine(lm, name="lm",
                                               metrics_window_s=3600,
                                               **gen_kw))
    free_garbage()
    rise = torch.cuda.memory_allocated() - m0
    new = {a: b for a, b in allocated_blocks().items() if a not in blocks0}
    specs = {"bert": (TenantSpec("bert", build_transformer,
                                 batch_size=BERT_BATCH), bert),
             "lm": (TenantSpec("lm", build_transformer, engine="generation",
                               generation=gen_kw), lm)}
    predicted = {n: model_residency(s, m.layers, m.input_tensors, None,
                                    model_config=m.config)["resident_bytes"]
                 for n, (s, m) in specs.items()}
    tensors = list(bert._params.values()) + list(lm._params.values())
    lm_eng = fleet._tenant("lm").engine
    tensors += [t for sub in lm_eng._caches.values() for t in sub.values()]
    nbytes = [t.numel() * t.element_size() for t in tensors]
    rounded = sum(-(-n // ALLOC_ROUND) * ALLOC_ROUND for n in nbytes)
    resident = {n: fleet.stats(n)["resident_bytes"] for n in specs}
    # the allocator's own account of the blocks that appeared: each
    # block's requested bytes and its size (rounded to 512 bytes, and a
    # large-pool block keeps an unsplit remainder of at most 1 MiB)
    ptrs = {t.data_ptr() for t in tensors}
    requested = sum(b[1] for b in new.values())
    block_bytes = sum(b[0] for b in new.values())
    strays = sorted((b[1], b[0]) for a, b in new.items() if a not in ptrs)
    print(f"fleet memory: gate resident bytes {json.dumps(predicted)} "
          f"(sum {sum(predicted.values()):.0f}), the tenants' tensors "
          f"{sum(nbytes)} bytes in {len(nbytes)} tensors, "
          f"{rounded} in {ALLOC_ROUND}-byte blocks; memory_allocated rose "
          f"{rise} bytes: {len(new)} new blocks requesting {requested} "
          f"bytes in {block_bytes} bytes of blocks (rounding "
          f"{block_bytes - requested}); blocks not a tenant tensor's "
          f"(requested, size): {strays[:8]} [{card}]")
    assert resident == predicted, (resident, predicted)
    assert sum(nbytes) == sum(predicted.values())

    rng = np.random.default_rng(SEED)
    rows = [rng.integers(0, BERT["vocab_size"], (BERT_BATCH,
                                                 BERT["seq_len"])
                         ).astype(np.int32)
            for _ in range(FLEET_BERT_REQUESTS)]
    prompts = gen_traffic(np.random.default_rng(SEED),
                          GPT2["vocab_size"])[:FLEET_GEN_REQUESTS]
    reset_counts(*counters)
    t0 = time.perf_counter()
    with fleet:
        futs = [fleet.submit("bert", x) for x in rows]
        streams = [fleet.submit("lm", p, max_new_tokens=FLEET_GEN_NEW)
                   for p in prompts]
        got_rows = [f.result(timeout=600) for f in futs]
        got_toks = [s.result(timeout=600).tolist() for s in streams]
        wall = time.perf_counter() - t0
        stats = fleet.stats()
    launches = {"fwd": fwd_k.launches, "bwd": bwd_k.launches,
                "ln": ln_k.launches}
    bs, gs = stats["tenants"]["bert"], stats["tenants"]["lm"]
    gen_disp = lm_eng._n_steps + lm_eng._chunks_total
    layers, lm_layers = BERT["num_layers"], GPT2["num_layers"]
    print(f"fleet serve: {FLEET_BERT_REQUESTS} BERT-base requests of "
          f"{BERT_BATCH} rows and {FLEET_GEN_REQUESTS} LM prompts x "
          f"{FLEET_GEN_NEW} tokens in {wall:.3f}s; charged device seconds "
          f"bert {bs['vtime_s']} (weight {bs['weight']}), lm "
          f"{gs['vtime_s']} (weight {gs['weight']}), {stats['dispatches']} "
          f"fleet dispatches; launches: flash forward {launches['fwd']} "
          f"= {layers} x {bs['dispatches']} BERT dispatches, layernorm "
          f"{launches['ln']} = {2 * layers} x {bs['dispatches']} + "
          f"{2 * lm_layers} x {gen_disp} LM dispatches, flash backward "
          f"{launches['bwd']} [{card}]")
    assert bs["requests"] == FLEET_BERT_REQUESTS and bs["errors"] == 0
    assert gs["requests"] == FLEET_GEN_REQUESTS and gs["errors"] == 0
    assert launches == {"fwd": layers * bs["dispatches"], "bwd": 0,
                        "ln": 2 * layers * bs["dispatches"]
                        + 2 * lm_layers * gen_disp}, \
        (launches, bs["dispatches"], gen_disp)
    # the standalone engines on the same models and traffic
    with ft.ServingEngine(bert, max_batch=BERT_BATCH) as eng:
        want_rows = [eng.submit(x).result(timeout=600) for x in rows]
    want_toks = colo_run(ft, lm, prompts, FLEET_GEN_NEW, "off")["tokens"]
    same_rows = all(np.array_equal(a, b)
                    for a, b in zip(got_rows, want_rows))
    print(f"fleet vs standalone: BERT-base rows bit-equal {same_rows}, "
          f"LM tokens equal {got_toks == want_toks} [{card}]")
    assert same_rows and got_toks == want_toks
    # the rise is the tenants' tensors and the allocator's rounding of
    # their blocks, nothing else
    assert rise == block_bytes and requested == sum(nbytes) \
        and not strays, (rise, block_bytes, requested, strays[:8])
    del fleet, bert, lm, lm_eng
    free_garbage()
    return launches


# ----------------------------------------------------------------------
# the pipeline phase: pipeline stages on one card
# ----------------------------------------------------------------------
# a pipeline_transformer_block at BERT-base's widths: 12 encoder stages
# of d 768, 12 heads, d_ff 3072, between a 30522-token embedding and a
# 2-class head on the first position; batch 16, s 512, bf16, 4
# microbatches.  Its float32 twin has 2 stages at the same widths
PIPE = dict(num_stages=12, num_heads=12, d_ff=3072, num_microbatches=4)
PIPE_TWIN = dict(num_stages=2, batch=4, seq=128)
# the mesh runs' float32 twins of the block (MESH_RUNS "pipe_f32_*"),
# and the stages of its bf16 runs (12, PIPE's, until the calibration
# phase needed the time)
MESH_PIPE_TWIN = dict(num_stages=4, batch=8, seq=64)
MESH_PIPE_STAGES = 4


def pipe_model(ft, device=None, dtype="bfloat16", batch=BERT_BATCH,
               seq=BERT["seq_len"], mesh=None, **block):
    """The pipeline model (``PIPE`` updated by ``block``), compiled with
    SGD (lr 0.01) on ``mesh`` or one device, its parameters from SEED,
    and its batch."""
    import numpy as np

    kw = dict(PIPE, **block)
    cfg = ft.FFConfig(batch_size=batch, compute_dtype=dtype, seed=SEED)
    m = ft.FFModel(cfg, device=device)
    tok = m.create_tensor((batch, seq), dtype="int32", name="tokens")
    t = m.embedding(tok, BERT["vocab_size"], BERT["d_model"], aggr="none")
    t = m.pipeline_transformer_block(t, **kw)
    t = m.reshape(m.split(t, [1, seq - 1], axis=1)[0],
                  (batch, BERT["d_model"]))
    logits = m.dense(t, BERT["num_classes"])
    m.compile(ft.SGDOptimizer(lr=0.01), metrics=["accuracy"],
              final_tensor=logits, mesh=mesh)
    m.init_layers(seed=SEED)
    rng = np.random.default_rng(SEED)
    return m, (rng.integers(0, BERT["vocab_size"], (batch, seq)).astype(
        np.int32), rng.integers(0, BERT["num_classes"], (batch, 1)).astype(
        np.int32))


def pipe_ln_shapes() -> list:
    """The (rows, s, d) operands the block's residual LayerNorm sites
    get: the whole batch on one card (the p == 1 path, and its float32
    twin), and each mesh run's microbatch on a rank (its share of the
    batch over n, cut into M)."""
    d = BERT["d_model"]
    out = [(BERT_BATCH, BERT["seq_len"], d),
           (PIPE_TWIN["batch"], PIPE_TWIN["seq"], d)]
    for name, (shape, _, _) in MESH_RUNS.items():
        if name.startswith("pipe"):
            batch, seq = ((MESH_PIPE_TWIN["batch"], MESH_PIPE_TWIN["seq"])
                          if "f32" in name else (BERT_BATCH, BERT["seq_len"]))
            rows = batch // shape.get("n", 1) // PIPE["num_microbatches"]
            out.append((rows, seq, d))
    return list(dict.fromkeys(out))


def pipeline_phase(ft, cuda_norm, counters, card: str) -> dict:
    """The pipeline block on one card (the p == 1 path: the stages in
    order over the whole batch): predict, then one train_batch, bf16,
    with the LayerNorm kernel's launches counted (its two ln(x + attn)
    sites a stage a forward); a residual launch at each shape a site
    gets here and on a mesh rank (``pipe_ln_shapes``) held against the
    plain version; a float32 twin of 2 stages, predict and a step,
    against the port's own CPU run from the same weights."""
    import numpy as np
    import torch

    stages = PIPE["num_stages"]
    model, (x, y) = pipe_model(ft)
    reset_counts(*counters)
    t0 = time.perf_counter()
    out = model.predict(x)
    torch.cuda.synchronize()
    pred_s = time.perf_counter() - t0
    ln_fwd = counters[2].launches
    assert out.shape == (BERT_BATCH, 2) and np.all(np.isfinite(out)), out
    assert ln_fwd == 2 * stages, ln_fwd
    reset_counts(*counters)
    xb = model._to_device((x, y))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss = float(model.train_batch(*xb))
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3
    ln_step = counters[2].launches
    assert ln_step == 2 * stages and np.isfinite(loss), (ln_step, loss)
    assert counters[0].launches == counters[1].launches == 0
    busy = busy_ms(lambda: model.train_batch(*xb))
    print(f"pipeline block on one card ({stages} stages, d "
          f"{BERT['d_model']}, {PIPE['num_heads']} heads, d_ff "
          f"{PIPE['d_ff']}, batch {BERT_BATCH}, s {BERT['seq_len']}, bf16, "
          f"M {PIPE['num_microbatches']}): predict {pred_s:.3f} s wall, "
          f"layernorm launches a forward {ln_fwd} (= 2 x {stages} stages), "
          f"a step {ln_step}; step loss {loss:.4f}, step wall "
          f"{step_ms:.3f} ms, a step's busy {busy:.3f} ms [{card}]")
    del model
    free_garbage()
    torch.cuda.empty_cache()

    # the residual launch at every shape a site gets, on one card and on
    # a rank of each mesh run (each picks its own launch plan)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 15)
    d = BERT["d_model"]
    scale = torch.rand(d, generator=gen, device="cuda") + 0.5
    bias = torch.randn(d, generator=gen, device="cuda")
    err = 0.0
    for rows in pipe_ln_shapes():
        xa, res = (torch.randn(rows, generator=gen, device="cuda")
                   for _ in range(2))
        err = max(err, ln_check(cuda_norm, xa, res, scale, bias,
                                " (the pipeline block's ln(x + attn))"))

    twin = dict(PIPE_TWIN)
    batch, seq = twin.pop("batch"), twin.pop("seq")
    got = []
    for device in ("cuda", "cpu"):
        m, (tx, ty) = pipe_model(ft, device, "float32", batch, seq,
                                 num_microbatches=2, **twin)
        reset_counts(*counters)
        pred = m.predict(tx)
        loss_t = float(m.train_batch(tx, ty))
        if device == "cuda":
            assert counters[2].launches == 2 * 2 * twin["num_stages"], \
                counters[2].launches
        got.append((pred, loss_t, {p.name: m.get_weights(p.name)
                                   for p in m.parameters}))
        del m
    (pc, lc, wc), (ph, lh, wh) = got
    pred_err = float(np.abs(pc - ph).max())
    loss_err = abs(lc - lh)
    param_err = max(float(np.abs(wc[k] - wh[k]).max()) for k in wh)
    print(f"f32 pipeline block ({twin['num_stages']} stages, batch {batch}, "
          f"s {seq}) cuda (kernels) vs cpu (plain): predict max abs err "
          f"{pred_err:.3g}, step loss {lc:.6f} vs {lh:.6f}, max abs err "
          f"over the updated parameters {param_err:.3g} (tolerance "
          f"{F32_STEP_TOL}) [{card}]")
    assert max(pred_err, loss_err, param_err) <= F32_STEP_TOL, (
        pred_err, loss_err, param_err)
    return {"ln": ln_fwd + ln_step, "max_abs_err": err}


# ----------------------------------------------------------------------
# the mesh phase: MESH_WORLD ranks on the one card
# ----------------------------------------------------------------------
# four ranks share the card: NCCL refuses two ranks on one GPU, so the
# phase names gloo for both device types itself
MESH_WORLD = 4
MESH_BACKEND = "cpu:gloo,cuda:gloo"
# the float32 twins' mesh step against the one-rank step
MESH_RTOL, MESH_ATOL = 1e-4, 1e-5
# the bf16 runs: the L2 norm of the difference of the mesh's and the one
# rank's change of a state over all trainable parameters, within this
# share of the one rank's change (ROADMAP C: the rule the ResNet-50
# step is held by).  SGD's state is the parameters; under Adam, whose
# first step moves every parameter by about alpha whatever its
# gradient, the state held is the first moment, (1 - beta1) times the
# gradient after one step, and the parameters' share is printed
MESH_L2_SHARE = 0.15
MESH_TIMEOUT = 600
MESH_BERT_LAYERS = 2


def mesh_pc(ft, dims):
    return ft.ParallelConfig(dims=tuple(dims),
                             device_ids=tuple(range(math.prod(dims))))


def mesh_tf_strategies(ft, layers: int, attention, ffn_up) -> dict:
    out = {}
    for i in range(layers):
        out[f"attention_{i}"] = mesh_pc(ft, attention)
        out[f"ffn_up_{i}"] = mesh_pc(ft, ffn_up)
    return out


# the runs of the phase: mesh shape, the kernels expected a step on
# each rank (pool forward, pool backward, flash forward, flash backward,
# LayerNorm) and the steps.  "cnn_f32" is the multichip dryrun's CNN
# (__graft_entry__.py), "tf_f32_*" a 2-layer transformer with the
# dryrun's strategies; both float32, held at MESH_RTOL.  AlexNet (229 px,
# batch 64) and BERT-base (batch 16, s 512; MESH_BERT_LAYERS of its 12
# layers, cut from 6 to make room for the calibration phase) run bf16 at
# full width
MESH_RUNS = {
    "cnn_f32": ({"n": 2, "c": 2}, (1, 1, 0, 0, 0), 1),
    "tf_f32_s2c2": ({"s": 2, "c": 2}, (0, 0, 0, 0, 4), 1),
    "tf_f32_n2c2": ({"n": 2, "c": 2}, (0, 0, 2, 2, 4), 1),
    "alexnet": ({"n": 2, "c": 2}, (3, 3, 0, 0, 0), 2),
    "bert_n2c2": ({"n": 2, "c": 2}, (0, 0, 2, 2, 4), 1),
    "bert_s2c2": ({"s": 2, "c": 2}, (0, 0, 0, 0, 4), 1),
    # the pipeline block (PIPE's widths, bf16, MESH_PIPE_STAGES of its
    # 12 stages) over p, GPipe, and interleaved at {"n": 2, "p": 2} with
    # 2 chunks a rank; their float32 twins (4 stages, smaller batch and
    # sequence); the smoke's MoE (MOE, float32) over e; and the dryrun's
    # composed program at {"e": 2, "p": 2} (float32) and its twin
    # (COMPOSED_TWIN_*).  A rank runs no bubble tick, so its LayerNorm
    # launches a step are 2 x its stages x M: 1 x 4 x 2 = 8 at p 4 and
    # 2 x 4 x 2 = 16 interleaved, in either dtype (the backward
    # recomputes the plain version: no launch)
    "pipe_p4": ({"p": 4}, (0, 0, 0, 0, 8), 1),
    "pipe_n2p2": ({"n": 2, "p": 2}, (0, 0, 0, 0, 16), 1),
    "pipe_f32_p4": ({"p": 4}, (0, 0, 0, 0, 8), 1),
    "pipe_f32_n2p2": ({"n": 2, "p": 2}, (0, 0, 0, 0, 16), 1),
    "moe_e4": ({"e": 4}, (0, 0, 0, 0, 0), 1),
    "moe_n2e2": ({"n": 2, "e": 2}, (0, 0, 0, 0, 0), 1),
    "composed_e2p2": ({"e": 2, "p": 2}, (0, 0, 0, 0, 0), 1),
    "composed_f32_e2p2": ({"e": 2, "p": 2}, (0, 0, 0, 0, 0), 1),
}
# the composed program's input (batch, s, d) and its stage's MoE (the
# dryrun's: k 1, capacity factor 4.0).  A MoE routes over the tokens it
# is given under a capacity fixed by the whole batch, and its
# load-balance loss is a mean over them, so the one-rank run it is held
# against computes the pipeline's function: the stages over each
# microbatch (``pipelined``).  At these widths no microbatch fills an
# expert (its capacity, 1024, is a microbatch's tokens); the float32
# twin routes a smaller batch under capacity factor 1.0, 32 tokens an
# expert against a microbatch's 128, which binds.
# tests/test_torch_mesh_pipeline.py holds the composed program, and a
# binding 8-expert stage, against the JAX package's pipeline
COMPOSED_SHAPE = (4, 512, 768)
COMPOSED_MOE = dict(num_experts=8, d_ff=3072, k=1, capacity_factor=4.0)
COMPOSED_TWIN_SHAPE = (4, 64, 768)
COMPOSED_TWIN_MOE = dict(COMPOSED_MOE, capacity_factor=1.0)
MESH_TF_F32 = dict(num_layers=2, d_model=64, num_heads=4, d_ff=128,
                   seq_len=32, vocab_size=128, num_classes=4)


def mesh_model(ft, name: str, mesh=None, strategies: bool = True):
    """The run's model, compiled (on ``mesh`` when given; without its
    strategies when ``strategies`` is False), its parameters from SEED,
    and its batch."""
    import numpy as np
    from flexflow_tpu_torch.models import build_alexnet, build_transformer

    rng = np.random.default_rng(SEED)
    if name.startswith("pipe"):
        twin = "f32" in name
        block = dict(schedule="interleaved", virtual_stages=2) \
            if name.endswith("n2p2") else {}
        if twin:
            return pipe_model(ft, dtype="float32", mesh=mesh,
                              **MESH_PIPE_TWIN, **block)
        return pipe_model(ft, mesh=mesh, num_stages=MESH_PIPE_STAGES,
                          **block)
    if name.startswith("moe") or name.startswith("composed"):
        composed = name.startswith("composed")
        twin = "f32" in name
        shape = (COMPOSED_TWIN_SHAPE if twin else COMPOSED_SHAPE) \
            if composed else MOE_SHAPE
        moe = COMPOSED_TWIN_MOE if twin else COMPOSED_MOE
        cfg = ft.FFConfig(batch_size=shape[0], compute_dtype="float32",
                          seed=SEED)
        model = ft.FFModel(cfg)
        t = model.create_tensor(shape, name="x")
        if composed:
            def stage(seg, h):
                h = seg.dense(h, 3072, activation="relu")
                return seg.moe(seg.dense(h, shape[-1]), **moe)
            t = model.pipeline(t, num_stages=2, stage_builder=stage,
                               num_microbatches=2)
        else:
            t = model.moe(t, name="moe0", **MOE)
        logits = model.dense(model.reshape(t, (shape[0], shape[1] * shape[2])),
                             4)
        model.compile(ft.SGDOptimizer(lr=0.01), metrics=["accuracy"],
                      final_tensor=logits, mesh=mesh)
        model.init_layers(seed=SEED)
        return model, (rng.standard_normal(shape, dtype=np.float32),
                       rng.integers(0, 4, (shape[0], 1)).astype(np.int32))
    if name == "cnn_f32":
        cfg = ft.FFConfig(batch_size=8, compute_dtype="float32", seed=SEED)
        cfg.strategies = {"conv2d": mesh_pc(ft, (2, 1, 1, 1)),
                          "dense": mesh_pc(ft, (2, 2)),
                          "dense_1": mesh_pc(ft, (2, 2))}
        model = ft.FFModel(cfg)
        x = model.create_tensor((8, 3, 16, 16), name="img")
        t = model.conv2d(x, 8, 3, 3, 1, 1, 1, 1, activation="relu")
        t = model.pool2d(t, 2, 2, 2, 2, 0, 0)
        t = model.flat(t)
        t = model.dense(t, 32, activation="relu")
        logits = model.dense(t, 8)
        opt = ft.SGDOptimizer(lr=0.05, momentum=0.9)
        batch = (rng.standard_normal((8, 3, 16, 16), dtype=np.float32),
                 rng.integers(0, 8, (8, 1)).astype(np.int32))
    elif name == "alexnet":
        cfg = ft.FFConfig(batch_size=BATCH, compute_dtype="bfloat16",
                          seed=SEED)
        cfg.strategies = {n: mesh_pc(ft, (2, 1, 1, 1)) for n in (
            "conv2d", "conv2d_1", "conv2d_2", "conv2d_3", "conv2d_4")}
        cfg.strategies.update({n: mesh_pc(ft, (2, 2))
                               for n in ("dense", "dense_1", "dense_2")})
        model, _, logits = build_alexnet(cfg, num_classes=10,
                                         image_size=229)
        opt = ft.SGDOptimizer(lr=0.01, momentum=0.9)
        batch = (rng.standard_normal((BATCH, 3, 229, 229),
                                     dtype=np.float32),
                 rng.integers(0, 10, (BATCH, 1)).astype(np.int32))
    else:
        bert = name.startswith("bert")
        arch = (dict(BERT, num_layers=MESH_BERT_LAYERS) if bert
                else MESH_TF_F32)
        batch_size = BERT_BATCH if bert else 4
        cfg = ft.FFConfig(batch_size=batch_size, seed=SEED,
                          compute_dtype="bfloat16" if bert else "float32")
        split = (((1, 2, 1), (1, 1, 2)) if name.endswith("s2c2")
                 else ((2, 1, 2), (2, 1, 2)))
        cfg.strategies = mesh_tf_strategies(ft, arch["num_layers"], *split)
        model, _, logits = build_transformer(cfg, **arch)
        opt = (ft.AdamOptimizer(alpha=1e-4) if bert
               else ft.SGDOptimizer(lr=0.05))
        batch = (rng.integers(0, arch["vocab_size"],
                              (batch_size, arch["seq_len"])).astype(np.int32),
                 rng.integers(0, arch["num_classes"],
                              (batch_size, 1)).astype(np.int32))
    if not strategies:
        model.config.strategies = {}
    model.compile(opt, metrics=["accuracy"], final_tensor=logits, mesh=mesh)
    model.init_layers(seed=SEED)
    return model, batch


@contextlib.contextmanager
def pipelined(p: int):
    """On one rank, the pipeline ops compute what a pipeline of ``p``
    ranks computes: the stages (the p == 1 path) over each of the M
    microbatches, rows [m B / M, (m + 1) B / M) of the batch, and their
    auxiliary loss summed and divided by M (``_run_ticks`` in
    ``flexflow_tpu_torch/parallel/pipeline.py``).  Where a stage mixes
    rows (a MoE routes over its microbatch, under a capacity fixed by
    the whole batch) that differs from the stages over the whole
    batch."""
    import torch
    from flexflow_tpu_torch.ops import pipeline as ops_pipeline

    whole = ops_pipeline.pipeline_apply

    def apply(stage_fn, stacked, x, num_stages, line=None,
              num_microbatches=None, **kw):
        M = num_microbatches or p
        parts = [whole(stage_fn, stacked, xm, num_stages, None, **kw)
                 for xm in x.chunk(M)]
        return (torch.cat([y for y, _ in parts]),
                sum(a for _, a in parts) / M)

    ops_pipeline.pipeline_apply = apply
    try:
        yield
    finally:
        ops_pipeline.pipeline_apply = whole


def mesh_state(model, bf16: bool) -> dict:
    """The state a run is held by: the parameters, or under Adam the
    first moment (full values, gathered: every rank calls it)."""
    import numpy as np
    from flexflow_tpu_torch.parallel.sharding import gather
    from flexflow_tpu_torch.model import to_host

    names = sorted(model._trainable_names())
    out = {f"param/{k}": model.get_weights(k) for k in names}
    if bf16 and "m" in (model._opt_state or {}):
        out.update({f"m/{k}": np.array(to_host(gather(
            model._opt_state["m"][k]))) for k in names})
    return out


def busy_ms(fn) -> float:
    """Device busy time of one call of ``fn`` (the sum of its kernels'
    device time, torch profiler), or NaN where the profiler saw none."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    total = sum(e.self_device_time_total for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA)
    return total / 1e3 if total else float("nan")


def mesh_pool_check(model, batch, cuda_pool) -> int:
    """Each rank's local pool outputs against the plain version on the
    same local shard, bit-equal; returns the pools checked (these
    launches are not the path's: the counts were read before)."""
    import torch
    from flexflow_tpu_torch.model import _mesh_context
    from flexflow_tpu_torch.ops.conv import Pool2D

    with torch.no_grad(), _mesh_context(True):
        vals = model._forward_values(model._params,
                                     model._to_device(batch[:1]))
    pools = [op for op in model.layers if isinstance(op, Pool2D)]
    for op in pools:
        xl = vals[op.inputs[0].uid].to_local().contiguous(
            memory_format=torch.channels_last)
        y = cuda_pool.max_pool_nhwc(xl, op.kernel, op.stride, op.padding)
        ref = cuda_pool.max_pool_nhwc_reference(xl, op.kernel, op.stride,
                                                op.padding)
        assert_bit_equal(y, ref, f"{op.name} on the rank's shard")
        got = vals[op.outputs[0].uid].to_local()
        assert_bit_equal(got.contiguous(memory_format=torch.channels_last),
                         y, f"{op.name} output on the rank's shard")
    return len(pools)


def mesh_rank_main(argv) -> int:
    """One rank of the mesh phase: ``chip_smoke.py --mesh-rank <rank>
    <dir>``.  Runs every MESH_RUNS entry on its mesh, prints its lines
    and writes ``rank<r>.json`` (and, rank 0, each run's state)."""
    rank, workdir = int(argv[0]), argv[1]
    import numpy as np
    import torch
    sys.path.insert(0, HERE)
    import flexflow_tpu_torch as ft
    from flexflow_tpu_torch.ops import cuda_attention, cuda_norm, cuda_pool
    from flexflow_tpu_torch.parallel import distributed

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(2)
    ft.initialize_distributed(
        init_method="file://" + os.path.join(workdir, "store"),
        world_size=MESH_WORLD, rank=rank, backend=MESH_BACKEND)
    counters = (cuda_pool.max_pool_nhwc, cuda_pool.max_pool_nhwc_backward,
                cuda_attention.flash_attention_forward,
                cuda_attention.flash_attention_backward,
                cuda_norm.fused_layernorm)
    card = card_line()
    record = {}
    for name, (shape, want, steps) in MESH_RUNS.items():
        mesh = ft.MachineMesh(shape)
        model, batch = mesh_model(ft, name, mesh)
        bf16 = model.config.compute_dtype == "bfloat16"
        if rank == 0:
            np.savez(os.path.join(workdir, f"{name}-init.npz"),
                     **mesh_state(model, False))
        else:
            mesh_state(model, False)
        distributed.collectives.clear()
        losses, launches, walls = [], [], []
        for step in range(steps):
            reset_counts(*counters)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if step == steps - 1:
                busy = busy_ms(lambda: losses.append(
                    float(model.train_batch(*batch))))
            else:
                losses.append(float(model.train_batch(*batch)))
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
            launches.append([f.launches for f in counters])
            assert tuple(launches[-1]) == want, (
                f"{name} rank {rank} step {step}: launches {launches[-1]} "
                f"(pool fwd, pool bwd, flash fwd, flash bwd, layernorm), "
                f"want {want}")
        colls = {k: dict(v) for k, v in distributed.collectives.items()}
        pools = (mesh_pool_check(model, batch, cuda_pool)
                 if name in ("alexnet", "cnn_f32") else 0)
        state = mesh_state(model, bf16)
        if rank == 0:
            np.savez(os.path.join(workdir, f"{name}-final.npz"), **state)
        local = {k: list(v.to_local().shape) for k, v in
                 list(model._params.items())[:4]}
        print(f"mesh {name} rank {rank} {model.mesh}: losses {losses}, "
              f"launches a step {launches[-1]} (pool fwd, pool bwd, flash "
              f"fwd, flash bwd, layernorm), step wall "
              f"{[round(w, 3) for w in walls]} ms, last step busy "
              f"{busy:.3f} ms (the ranks share the card), collectives "
              f"{colls}, pools bit-equal on the shard {pools}, local "
              f"shards {local} [{card}]", flush=True)
        record[name] = {"losses": losses, "launches": launches,
                        "wall_ms": walls, "busy_ms": busy,
                        "collectives": colls, "pools_checked": pools}
        del model
        torch.cuda.empty_cache()
    # A.8b items 4-5: the in-process reshard and the sharded engine
    for name in RESHARD_RUNS:
        record[name] = mesh_reshard_rank(ft, name, rank, workdir, counters,
                                         card)
    for name in GEN_MESH_RUNS:
        record[name] = mesh_gen_rank(ft, name, rank, workdir, counters,
                                     card)
    # A.9: compile with search_budget on every rank, then train
    for name in SEARCH_MESH_RUNS:
        record[name] = mesh_search_rank(ft, name, rank, workdir, counters,
                                        card)
    with open(os.path.join(workdir, f"rank{rank}.json"), "w") as f:
        json.dump(record, f)
    ft.finalize_distributed()
    return 0


def mesh_nccl_main(argv) -> int:
    """``chip_smoke.py --mesh-nccl <dir>``: a one-rank group on the
    default backend (NCCL on the card); the dryrun CNN's float32 step on
    a {"n": 1} mesh against the step without a mesh, bit-equal."""
    workdir = argv[0]
    import torch
    import torch.distributed as dist
    sys.path.insert(0, HERE)
    import flexflow_tpu_torch as ft

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ft.initialize_distributed(
        init_method="file://" + os.path.join(workdir, "nccl-store"),
        world_size=1, rank=0)
    backend = str(dist.get_backend())
    assert backend == "nccl", backend
    out = {}
    for tag, mesh in (("mesh", ft.MachineMesh({"n": 1})), ("plain", None)):
        model, batch = mesh_model(ft, "cnn_f32", mesh, strategies=False)
        assert model._on_mesh == (mesh is not None), tag
        loss = float(model.train_batch(*batch))
        out[tag] = (loss, {k: model.get_weights(k)
                           for k in sorted(model._params)})
    import numpy as np
    assert out["mesh"][0] == out["plain"][0], (out["mesh"][0],
                                               out["plain"][0])
    for k, v in out["plain"][1].items():
        np.testing.assert_array_equal(out["mesh"][1][k], v, err_msg=k)
    print(f"mesh nccl one-rank group: backend {backend}, {{'n': 1}} mesh "
          f"step bit-equal to the step without a mesh (loss "
          f"{out['mesh'][0]!r}, {len(out['plain'][1])} parameters) "
          f"[{card_line()}]", flush=True)
    ft.finalize_distributed()
    return 0


def mesh_children(args, n: int, workdir: str) -> None:
    """Run ``n`` children ``chip_smoke.py <args> <i> <workdir>`` (or one
    ``<args> <workdir>``) together; print each one's output; raise if
    one fails or outlasts MESH_TIMEOUT (every child is stopped)."""
    procs = []
    for i in range(n):
        cmd = [sys.executable, os.path.abspath(__file__), *args]
        cmd += [str(i), workdir] if n > 1 else [workdir]
        log = open(os.path.join(workdir, f"{args[0][2:]}-{i}.log"), "w")
        procs.append((subprocess.Popen(cmd, stdout=log,
                                       stderr=subprocess.STDOUT), log))
    deadline = time.monotonic() + MESH_TIMEOUT
    codes = []
    try:
        for p, _ in procs:
            codes.append(p.wait(timeout=max(1.0,
                                            deadline - time.monotonic())))
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    for i in range(n):
        with open(os.path.join(workdir, f"{args[0][2:]}-{i}.log")) as f:
            text = f.read()
        lines = [ln for ln in text.splitlines()
                 if ln.startswith("mesh ") or codes[i]]
        print("\n".join(lines[-60:] if codes[i] else lines))
    assert not any(codes), f"{args[0]} children exited {codes}"


def hold_mesh_state(name, shape, dtype, mesh_losses, losses, one, got,
                    init, card: str) -> None:
    """A mesh run's final state ``got`` against the one-rank run's
    ``one`` from the same ``init``: float32 runs at MESH_RTOL/MESH_ATOL,
    bf16 runs by the L2 share of the difference (MESH_L2_SHARE)."""
    import numpy as np

    if dtype != "bfloat16":
        np.testing.assert_allclose(mesh_losses, losses, rtol=MESH_RTOL,
                                   atol=MESH_ATOL)
        worst = 0.0
        for k, v in one.items():
            np.testing.assert_allclose(got[k], v, rtol=MESH_RTOL,
                                       atol=MESH_ATOL, err_msg=k)
            worst = max(worst, float(np.max(np.abs(got[k] - v))))
        print(f"mesh {name} {shape}: the mesh step equals the one-rank "
              f"step on the card (losses {mesh_losses} / {losses}, "
              f"largest parameter difference {worst:.3g}, rtol "
              f"{MESH_RTOL}) [{card}]")
        return
    held = "m/" if any(k.startswith("m/") for k in one) else "param/"
    shares = {}
    for prefix in ("param/", "m/"):
        keys = [k for k in one if k.startswith(prefix)]
        if not keys:
            continue
        base = {k: init[k] if prefix == "param/" else 0.0 for k in keys}
        d_one = sum(float(np.sum((one[k] - base[k]) ** 2)) for k in keys)
        d_gap = sum(float(np.sum((got[k] - one[k]) ** 2)) for k in keys)
        shares[prefix[:-1]] = math.sqrt(d_gap / max(d_one, 1e-30))
    share = shares[held[:-1]]
    print(f"mesh {name} {shape} {dtype}: losses {mesh_losses} "
          f"against one rank's {losses}; L2 of the difference over L2 "
          f"of the one-rank change: {shares} (held: {held[:-1]} <= "
          f"{MESH_L2_SHARE}) [{card}]")
    assert share <= MESH_L2_SHARE, (name, shares)
    assert np.all(np.isfinite(mesh_losses)), mesh_losses


def mesh_phase(ft, card: str) -> dict:
    """MESH_WORLD ranks on the card over MESH_BACKEND run MESH_RUNS; then
    this process runs each one on one rank, and holds the mesh's against
    it, beside a one-rank NCCL group.  Returns the kernels' launches by
    run, summed over the ranks."""
    import tempfile

    import numpy as np
    import torch

    free_garbage()
    torch.cuda.empty_cache()
    workdir = tempfile.mkdtemp(prefix="ff-mesh-")
    t0 = time.perf_counter()
    mesh_children(["--mesh-rank"], MESH_WORLD, workdir)
    print(f"mesh ranks: {MESH_WORLD} processes on one card over "
          f"{MESH_BACKEND} in {time.perf_counter() - t0:.1f} s [{card}]")
    # the one-rank NCCL group runs in its own process beside the checks
    # below, which need no card time of their own while it starts
    nccl_error = []

    def run_nccl():
        try:
            mesh_children(["--mesh-nccl"], 1, workdir)
        except BaseException as e:  # noqa: BLE001 — re-raised below
            nccl_error.append(e)

    nccl = threading.Thread(target=run_nccl)
    nccl.start()
    ranks = []
    for r in range(MESH_WORLD):
        with open(os.path.join(workdir, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    names = ("pool fwd", "pool bwd", "flash fwd", "flash bwd", "layernorm")
    launches = {}
    for name, (shape, want, steps) in MESH_RUNS.items():
        launches[name] = [sum(sum(r[name]["launches"][s][i]
                                  for s in range(steps)) for r in ranks)
                          for i in range(len(names))]
        with np.load(os.path.join(workdir, f"{name}-init.npz")) as z:
            init = {k: z[k] for k in z.files}
        # the one rank computes the pipeline's function
        with pipelined(shape.get("p", 1)):
            model, batch = mesh_model(ft, name, None, strategies=False)
            mine = mesh_state(model, False)
            for k, v in init.items():   # both drew them from SEED
                np.testing.assert_array_equal(v, mine[k], err_msg=k)
            losses = [float(model.train_batch(*batch))
                      for _ in range(steps)]
        model_dtype = model.config.compute_dtype
        one = mesh_state(model, model_dtype == "bfloat16")
        del model
        torch.cuda.empty_cache()
        with np.load(os.path.join(workdir, f"{name}-final.npz")) as z:
            got = {k: z[k] for k in z.files}
        hold_mesh_state(name, shape, model_dtype, ranks[0][name]["losses"],
                        losses, one, got, init, card)
    for name in RESHARD_RUNS:
        launches[name] = [sum(sum(step[i] for step in r[name]["launches"])
                              for r in ranks) for i in range(len(names))]
        mesh_reshard_check(name, workdir, ranks, card)
    for name in GEN_MESH_RUNS:
        launches[name] = [sum(r[name]["launches"][i] for r in ranks)
                          for i in range(len(names))]
        mesh_gen_check(ft, name, ranks, card, {"ref": 0})
    for name in SEARCH_MESH_RUNS:
        launches[name] = [sum(sum(step[i] for step in r[name]["launches"])
                              for r in ranks) for i in range(len(names))]
        mesh_search_check(ft, name, workdir, ranks, card)
    for name, counts in launches.items():
        print(f"mesh launches over the {MESH_WORLD} ranks, {name}: "
              + ", ".join(f"{n} {c}" for n, c in zip(names, counts))
              + f" [{card}]")
    colls = {}
    for r in ranks:
        for run in r.values():
            for k, v in run.get("collectives", {}).items():
                c = colls.setdefault(k, {"calls": 0, "bytes": 0,
                                         "host": v["host"]})
                c["calls"] += v["calls"]
                c["bytes"] += v["bytes"]
    print("mesh collectives over the ranks and runs (host: staged through "
          f"pinned host memory) [{card}]: " + json.dumps(colls))
    nccl.join()
    if nccl_error:
        raise nccl_error[0]
    return {"launches": launches, "collectives": colls}


# ----------------------------------------------------------------------
# A.8b items 4-5 on the mesh's ranks: an in-process reshard of BERT-base
# and the strategy-sharded generation engine
# ----------------------------------------------------------------------
# bert_reshard: BERT-base (bf16, batch 16, s 512, Adam; RESHARD_BERT_LAYERS
# of its 12 layers: the move, its checkpoint and the launches a step are
# the same at every depth, and the smoke's later phases need the time)
# with the bert_n2c2 strategies, 2 steps at {"n": 2, "c": 2}, the step-2
# checkpoint, FFModel.reshard in process to {"n": 4}, 2 more steps; the
# reference is a model fixed at {"n": 4} that loads the checkpoint and
# takes the same 2 steps.  Predicted launches a step on each rank (pool
# fwd, pool bwd, flash fwd, flash bwd, layernorm), the same on both
# sides of the move: the attention's local batch and heads in one
# launch a layer, the LayerNorms on the local rows.  The float32 twin
# (BERT-base's widths at RESHARD_TWIN_LAYERS layers) must match its
# reference bit for bit; bf16 is held by the L2 share (MESH_L2_SHARE)
RESHARD_BERT_LAYERS = 4
RESHARD_RUNS = {
    "bert_reshard": ({"n": 2, "c": 2}, {"n": 4},
                     (0, 0, RESHARD_BERT_LAYERS, RESHARD_BERT_LAYERS,
                      2 * RESHARD_BERT_LAYERS), 2),
    "bert_f32_reshard": ({"n": 2, "c": 2}, {"n": 4}, (0, 0, 2, 2, 4), 2),
}
RESHARD_TWIN_LAYERS = 2
# gen_n2c2: the generation LM (GPT2 above, at 6 of its 12 layers: the
# sharding is the same in every layer, and later phases need the time)
# through
# GenerationEngine.from_strategy at {"n": 2, "c": 2} (attention, FFN and
# token embedding (2, 1, 2), tests/test_generation.py's strategy), 8
# greedy prompts x GEN_MESH_NEW tokens on 8 slots; its float32 twin at 2
# layers.  Predicted on each rank: 2 LayerNorm launches a layer a
# dispatch (12 at 6 layers, 4 in the twin), warm-up dispatches included,
# no flash launch (the paged attention is plain torch), a KV pool half
# of one device's
GEN_MESH_RUNS = {"gen_n2c2": ("bfloat16", 6),
                 "gen_f32_n2c2": ("float32", 2)}
GEN_MESH_SLOTS = 8
GEN_MESH_PROMPTS = 8
GEN_MESH_NEW = 16   # 32 until the examples phase needed the time
GEN_MESH_PROMPT = (32, 96)
GEN_MESH_OPS = ("tok_embedding",) + tuple(
    f"{op}_{i}" for i in range(GPT2["num_layers"])
    for op in ("attention", "ffn_up", "ffn_down"))


def reshard_model(ft, name: str, mesh):
    """The reshard run's model on ``mesh`` and its batch: BERT-base
    (bf16, Adam 1e-4) at RESHARD_BERT_LAYERS layers with the bert_n2c2
    strategies, or its float32 twin at RESHARD_TWIN_LAYERS layers;
    parameters from SEED."""
    import numpy as np
    from flexflow_tpu_torch.models import build_transformer

    twin = "f32" in name
    arch = dict(BERT, num_layers=RESHARD_TWIN_LAYERS if twin
                else RESHARD_BERT_LAYERS)
    cfg = ft.FFConfig(batch_size=BERT_BATCH, seed=SEED,
                      compute_dtype="float32" if twin else "bfloat16")
    cfg.strategies = mesh_tf_strategies(ft, arch["num_layers"], (2, 1, 2),
                                        (2, 1, 2))
    model, _, logits = build_transformer(cfg, **arch)
    model.compile(ft.AdamOptimizer(alpha=1e-4), metrics=["accuracy"],
                  final_tensor=logits, mesh=mesh)
    model.init_layers(seed=SEED)
    rng = np.random.default_rng(SEED)
    batch = (rng.integers(0, arch["vocab_size"],
                          (BERT_BATCH, arch["seq_len"])).astype(np.int32),
             rng.integers(0, arch["num_classes"],
                          (BERT_BATCH, 1)).astype(np.int32))
    return model, batch


def mesh_reshard_rank(ft, name: str, rank: int, workdir: str, counters,
                      card: str) -> dict:
    """One rank's reshard run (RESHARD_RUNS): the launches of every step
    of the resharded model (the counts set to 0 just before each step),
    the reshard's wall ms and the bytes it gathered, then the fixed
    reference; rank 0 saves both final states."""
    import numpy as np
    import torch
    from flexflow_tpu_torch.model import _flatten_state

    src, dst, want, steps = RESHARD_RUNS[name]
    model, batch = reshard_model(ft, name, ft.MachineMesh(src))
    bf16 = model.config.compute_dtype == "bfloat16"
    losses, launches = [], []

    def step():
        reset_counts(*counters)
        losses.append(float(model.train_batch(*batch)))
        torch.cuda.synchronize()
        launches.append([f.launches for f in counters])
        assert tuple(launches[-1]) == want, (
            f"{name} rank {rank} step {len(losses)}: launches "
            f"{launches[-1]}, want {want}")

    for _ in range(steps):
        step()
    ckpt = os.path.join(workdir, f"{name}_step{steps}.npz")
    t0 = time.perf_counter()
    model.save_checkpoint(ckpt)
    save_s = time.perf_counter() - t0
    gathered = sum(v.numel() * v.element_size()
                   for v in model._params.values())
    gathered += sum(v.numel() * v.element_size()
                    for v in _flatten_state(model._opt_state)
                    if torch.is_tensor(v))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    report = model.reshard(new_mesh=dst)
    torch.cuda.synchronize()
    reshard_ms = (time.perf_counter() - t0) * 1e3
    for _ in range(steps):
        step()
    state = mesh_state(model, bf16)
    local = {k: list(v.to_local().shape) for k, v in
             list(model._params.items())[2:5]}
    del model
    free_garbage()
    torch.cuda.empty_cache()
    ref, _ = reshard_model(ft, name, ft.MachineMesh(dst))
    ref.load_checkpoint(ckpt)
    ref_losses = [float(ref.train_batch(*batch)) for _ in range(steps)]
    ref_state = mesh_state(ref, bf16)
    del ref
    free_garbage()
    torch.cuda.empty_cache()
    if rank == 0:
        np.savez(os.path.join(workdir, f"{name}-resharded.npz"), **state)
        np.savez(os.path.join(workdir, f"{name}-fixed.npz"), **ref_state)
    print(f"mesh {name} rank {rank}: {src} -> {dst} in process after "
          f"step {steps}: reshard {reshard_ms:.3f} ms wall, "
          f"{gathered} bytes gathered (parameters and optimizer state), "
          f"checkpoint save {save_s:.3f} s; losses {losses}, the fixed "
          f"{dst} run from the step-{steps} checkpoint {ref_losses}; "
          f"launches a step {launches} (pool fwd, pool bwd, flash fwd, "
          f"flash bwd, layernorm); local shards after {local}; report "
          f"{report} [{card}]", flush=True)
    return {"losses": losses, "ref_losses": ref_losses,
            "launches": launches, "reshard_ms": reshard_ms,
            "gathered_bytes": gathered, "save_s": save_s}


def gen_mesh_prompts() -> list:
    import numpy as np
    rng = np.random.default_rng(SEED + 16)
    return [rng.integers(1, GPT2["vocab_size"],
                         int(rng.integers(*GEN_MESH_PROMPT))).astype(np.int32)
            for _ in range(GEN_MESH_PROMPTS)]


def gen_mesh_model(ft, name: str):
    dtype, layers = GEN_MESH_RUNS[name]
    cfg = ft.FFConfig(batch_size=GEN_CHECKED[0], compute_dtype=dtype,
                      seed=SEED)
    cfg.serve_kv_page = GEN_PAGE
    model, _, logits = ft.build_transformer_lm(
        cfg, **dict(GPT2, num_layers=layers))
    return model, logits


def mesh_gen_rank(ft, name: str, rank: int, workdir: str, counters,
                  card: str) -> dict:
    """One rank of a sharded generation run (GEN_MESH_RUNS): a fresh LM
    through GenerationEngine.from_strategy, rank 0 submitting the
    prompts; the launches (counts set to 0 just before the engine
    starts, read after it stopped), dispatches, plan bytes and KV
    bytes."""
    import torch
    from flexflow_tpu_torch.strategy.proto import save_strategy_file

    model, _ = gen_mesh_model(ft, name)
    layers = GEN_MESH_RUNS[name][1]
    pb = os.path.join(workdir, f"{name}-rank{rank}.pb")
    save_strategy_file(pb, {op: mesh_pc(ft, (2, 1, 2))
                            for op in GEN_MESH_OPS
                            if op == "tok_embedding"
                            or int(op.rsplit("_", 1)[1]) < layers})
    eng = ft.GenerationEngine.from_strategy(
        model, pb, slots=GEN_MESH_SLOTS, max_new_tokens=GEN_MESH_NEW)
    pool = sum(t.numel() * t.element_size()
               for sub in eng._raw_decoder.init_cache().values()
               for t in sub.values())
    reset_counts(*counters)
    outs = []
    t0 = time.perf_counter()
    with eng:
        if rank == 0:
            streams = [eng.submit(p) for p in gen_mesh_prompts()]
            outs = [[int(t) for t in s.result(timeout=600)]
                    for s in streams]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = [f.launches for f in counters]
    snap = eng.stats()
    n = snap["plan_dispatches"]
    want = (0, 0, 0, 0, 2 * layers * n)
    assert tuple(launches) == want, (name, rank, launches, want)
    rec = {"outs": outs, "launches": launches, "dispatches": n,
           "plan_bytes": snap["plan_bytes"], "kv_cache_bytes":
           eng.kv_cache_bytes, "pool_bytes": pool, "wall_s": wall,
           "mesh": {a: s for a, s in model.mesh.sizes.items() if s > 1}}
    print(f"mesh {name} rank {rank} {model.mesh}: {n} dispatches "
          f"({snap['plan_bytes']} plan bytes, "
          f"{snap['plan_bytes'] / max(n, 1):.1f} a dispatch), launches "
          f"{launches} (pool fwd, pool bwd, flash fwd, flash bwd, "
          f"layernorm: {2 * layers} a dispatch), KV pool {pool} bytes "
          f"(kv_cache_bytes {eng.kv_cache_bytes}), {wall:.3f} s wall"
          + (f", {sum(len(o) for o in outs) / wall:.1f} tokens/s"
             if outs else "") + f" [{card}]", flush=True)
    del eng, model
    free_garbage()
    torch.cuda.empty_cache()
    return rec


def mesh_reshard_check(name: str, workdir: str, ranks, card: str) -> None:
    """The resharded run against the fixed one: the float32 twin bit for
    bit, bf16 by the L2 share (and whether it is bit-equal too)."""
    import numpy as np

    recs = [r[name] for r in ranks]
    with np.load(os.path.join(workdir, f"{name}-resharded.npz")) as z:
        got = {k: z[k] for k in z.files}
    with np.load(os.path.join(workdir, f"{name}-fixed.npz")) as z:
        ref = {k: z[k] for k in z.files}
    steps = RESHARD_RUNS[name][3]
    post, fixed = recs[0]["losses"][steps:], recs[0]["ref_losses"]
    same = post == fixed and all(np.array_equal(got[k], ref[k])
                                 for k in ref)
    d_gap = sum(float(np.sum((got[k].astype(np.float64) - ref[k]) ** 2))
                for k in ref if k.startswith("param/"))
    d_ref = sum(float(np.sum(ref[k].astype(np.float64) ** 2))
                for k in ref if k.startswith("param/"))
    share = math.sqrt(d_gap / max(d_ref, 1e-30))
    print(f"mesh {name}: the resharded run against the fixed run from the "
          f"checkpoint: losses {post} / {fixed}, bit-equal {same}, L2 of "
          f"the parameters' difference over their L2 {share:.3g}; reshard "
          f"{[round(r['reshard_ms'], 3) for r in recs]} ms wall by rank, "
          f"{recs[0]['gathered_bytes']} bytes gathered a rank [{card}]")
    if "f32" in name:
        assert same, (name, post, fixed)
    else:
        assert share <= MESH_L2_SHARE, (name, share)
        assert np.all(np.isfinite(post)), post


def mesh_gen_check(ft, name: str, ranks, card: str, counted) -> None:
    """The sharded engine's tokens against the one-device engine's on
    the same seed's weights: equal in float32; in bf16 equal wherever
    the full forward's top-2 gap exceeds GEN_LOGIT_TOL (gen_decided).
    Every follower ran rank 0's dispatches; each rank's pool is half of
    one device's."""
    import torch

    recs = [r[name] for r in ranks]
    assert len({r["dispatches"] for r in recs}) == 1, recs
    assert all(r["outs"] == [] for r in recs[1:])
    model, logits = gen_mesh_model(ft, name)
    model.compile(final_tensor=logits)
    model.init_layers(seed=SEED)
    prompts = gen_mesh_prompts()
    with ft.GenerationEngine(model, slots=GEN_MESH_SLOTS,
                             max_new_tokens=GEN_MESH_NEW) as eng:
        one = [[int(t) for t in eng.submit(p).result(timeout=600)]
               for p in prompts]
        one_bytes = eng.kv_cache_bytes
    outs = recs[0]["outs"]
    equal = sum(a == b for a, b in zip(outs, one))
    for r in recs:
        assert r["pool_bytes"] == r["kv_cache_bytes"] == one_bytes / 2, (
            r["pool_bytes"], r["kv_cache_bytes"], one_bytes)
    if "f32" in name:
        assert outs == one, (outs, one)
        print(f"mesh {name}: tokens of the sharded engine == the one-device "
              f"engine's ({len(outs)} prompts x {GEN_MESH_NEW}); KV pool "
              f"{recs[0]['pool_bytes']} bytes a rank, one device "
              f"{one_bytes} [{card}]")
    else:
        decided_all, agree_all = 0, True
        for lo in range(0, len(prompts), GEN_CHECKED[0]):
            ref = gen_reference(model, prompts[lo:lo + GEN_CHECKED[0]],
                                outs[lo:lo + GEN_CHECKED[0]], counted)
            decided, agree = gen_decided(
                ref, outs[lo:lo + GEN_CHECKED[0]], GEN_LOGIT_TOL)
            decided_all += int(decided.sum())
            agree_all = agree_all and agree
        print(f"mesh {name}: {equal} of {len(outs)} streams equal to the "
              f"one-device engine's; every token decided by the full "
              f"forward (top-2 gap > {GEN_LOGIT_TOL}, {decided_all} of "
              f"{len(outs) * GEN_MESH_NEW}) equal: {agree_all}; KV pool "
              f"{recs[0]['pool_bytes']} bytes a rank, one device "
              f"{one_bytes} [{card}]")
        assert agree_all, name
    del eng, model
    free_garbage()
    torch.cuda.empty_cache()


# ----------------------------------------------------------------------
# the elastic phase: run_elastic supervising MESH_WORLD ranks on the card
# ----------------------------------------------------------------------
ELASTIC_STEPS = 6
ELASTIC_EVERY = 2
ELASTIC_TIMEOUT = 180
ELASTIC_MLP = dict(batch=64, features=256, hidden=512, classes=16)


def elastic_model(ft, device: str):
    """The elastic ranks' small model: a 2-layer MLP, SGD with momentum,
    data parallel over the world (the mesh compile infers)."""
    e = ELASTIC_MLP
    cfg = ft.FFConfig(batch_size=e["batch"], compute_dtype="float32",
                      seed=SEED)
    model = ft.FFModel(cfg, device=device)
    x = model.create_tensor((e["batch"], e["features"]), name="x")
    t = model.dense(x, e["hidden"], activation="relu")
    t = model.dense(t, e["classes"])
    model.compile(ft.SGDOptimizer(lr=0.05, momentum=0.9),
                  "sparse_categorical_crossentropy", [], final_tensor=t)
    model.init_layers(seed=SEED)
    return model


def elastic_batch(step: int):
    import numpy as np
    e = ELASTIC_MLP
    rng = np.random.default_rng(1000 + step)
    return (rng.standard_normal((e["batch"], e["features"]),
                                dtype=np.float32),
            rng.integers(0, e["classes"], (e["batch"], 1)).astype(np.int32))


def elastic_rank_main(argv) -> int:
    """``chip_smoke.py --elastic-rank <workdir>``: one rank under
    run_elastic (torchrun's variables from the supervisor), on the card
    over gloo: resume from the newest valid checkpoint, train to
    ELASTIC_STEPS with a heartbeat a step and a checkpoint every
    ELASTIC_EVERY; FF_FAULT fires inside train_batch and
    save_checkpoint.  Rank 0 rewrites ``attempt<A>.json`` after every
    step (its losses, the resume, the times from this function's entry)
    and writes final.json at the end."""
    t_entry = time.time()
    workdir = argv[0]
    import torch
    sys.path.insert(0, HERE)
    import flexflow_tpu_torch as ft
    from flexflow_tpu_torch.resilience import Heartbeat, elastic_resume

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_num_threads(1)
    rank = int(os.environ["RANK"])
    attempt = int(os.environ.get("FF_ELASTIC_ATTEMPT", "0"))
    ft.initialize_distributed(backend=MESH_BACKEND)
    hb = Heartbeat(rank=rank)
    ckpt = os.path.join(workdir, "ckpt")
    model = elastic_model(ft, "cuda")
    with ft.fflogger.capture_events("elastic") as events:
        resumed = elastic_resume(model, ckpt)
    rec = {"resumed": os.path.basename(resumed) if resumed else "fresh",
           "step0": model._step, "losses": [],
           "ready_s": time.time() - t_entry,
           "events": [e["event"] for e in events]}
    hb.beat(model._step)
    while model._step < ELASTIC_STEPS:
        rec["losses"].append(float(model.train_batch(
            *elastic_batch(model._step))))
        rec.setdefault("first_step_s", time.time() - t_entry)
        if rank == 0:
            with open(os.path.join(workdir, f"attempt{attempt}.json"),
                      "w") as f:
                json.dump(rec, f)
        hb.beat(model._step)
        if model._step % ELASTIC_EVERY == 0 and model._step < ELASTIC_STEPS:
            model.save_checkpoint(os.path.join(
                ckpt, f"elastic_step{model._step}.npz"))
    if rank == 0:
        rec["world"] = torch.distributed.get_world_size()
        with open(os.path.join(workdir, "final.json"), "w") as f:
            json.dump(rec, f)
    ft.finalize_distributed()
    return 0


def elastic_run(workdir: str, nprocs: int, fault: str, max_restarts=2):
    """One supervised run of ``nprocs`` elastic ranks: the report, rank
    0's record of each attempt (None where it trained no step) and the
    run's wall seconds."""
    from flexflow_tpu_torch.parallel.elastic import run_elastic

    os.makedirs(os.path.join(workdir, "ckpt"), exist_ok=True)

    def argv(attempt, port, rank):
        return [sys.executable, os.path.abspath(__file__), "--elastic-rank",
                workdir]

    t0 = time.perf_counter()
    report = run_elastic(argv, nprocs, max_restarts=max_restarts,
                         attempt_timeout_s=ELASTIC_TIMEOUT,
                         poll_interval_s=0.2, backoff_base_s=0.05,
                         env={"FF_FAULT": fault},
                         checkpoint_dir=os.path.join(workdir, "ckpt"))
    wall = time.perf_counter() - t0
    assert report.success, [(a.cause, a.returncodes, a.tails)
                            for a in report.attempts]
    recs = []
    for i in range(len(report.attempts)):
        path = os.path.join(workdir, f"attempt{i}.json")
        recs.append(json.load(open(path)) if os.path.exists(path)
                    else None)
    return report, recs, wall


# the elastic phase's runs: three chains that run side by side (each a
# supervisor with its ranks): the uninterrupted run then the fixed
# two-rank run that resumes from its step-4 checkpoint (which the phase
# holds equal to the shrink's), the recovery run, and the shrink; as
# three chains they take the time of the longest, not of the sum.  The
# recovery run's plan: rank 3 killed at step 3
# (attempt 0); attempt 1 resumes from step 2 and every checkpoint it
# publishes is truncated (corrupt_ckpt:latest), rank 3 killed again at
# step 5; attempt 2 skips the corrupt step-4 file and falls back to
# step 2
ELASTIC_CHAINS = (
    (("clean", MESH_WORLD, ""), ("fixed2", MESH_WORLD // 2, "")),
    (("recover", MESH_WORLD, "kill_at_step:3,rank=3;corrupt_ckpt:latest,"
                             "attempt=1;kill_at_step:5,rank=3,attempt=1"),),
    (("shrink", MESH_WORLD, "shrink_at_step:4"),),
)


def elastic_phase(card: str) -> dict:
    """run_elastic supervising MESH_WORLD ranks on the card
    (ELASTIC_CHAINS): the recovered run's losses and final loss
    bit-equal to the uninterrupted run's after a kill
    (kill_at_step:3,rank=3) and after a fallback past a corrupt
    checkpoint (corrupt_ckpt:latest); the shrink_at_step:4 run a planned
    resize to 2 ranks through the supervisor, bit-equal to the fixed
    2-rank run from an equal step-4 checkpoint.  Returns each run's wall
    seconds."""
    import shutil
    import tempfile
    import threading

    import numpy as np
    from flexflow_tpu_torch.fflogger import capture_events

    root = tempfile.mkdtemp(prefix="ff-elastic-")
    runs, errors = {}, []

    def chain(steps):
        try:
            for tag, nprocs, fault in steps:
                wd = os.path.join(root, tag)
                os.makedirs(os.path.join(wd, "ckpt"))
                if tag == "fixed2":
                    shutil.copy(os.path.join(root, "clean", "ckpt",
                                             "elastic_step4.npz"),
                                os.path.join(wd, "ckpt"))
                runs[tag] = elastic_run(wd, nprocs, fault,
                                        max_restarts=0 if tag == "shrink"
                                        else 2)
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    t0 = time.perf_counter()
    with capture_events("elastic") as events:
        threads = [threading.Thread(target=chain, args=(c,))
                   for c in ELASTIC_CHAINS]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    wall = time.perf_counter() - t0
    if errors:
        raise errors[0]
    for tag, nprocs, fault in sum(ELASTIC_CHAINS, ()):
        report, recs, run_wall = runs[tag]
        print(f"elastic {tag} ({fault or 'no fault'}): attempts "
              + "; ".join(
                  f"{a.cause} {a.returncodes} on {a.num_processes} ranks "
                  f"in {a.elapsed_s} s" + (
                      f", resumed {r['resumed']} at step {r['step0']}, "
                      f"losses {r['losses']}, first step "
                      f"{r['first_step_s']:.3f} s after the rank's start "
                      f"(ready {r['ready_s']:.3f} s)" if r else "")
                  for a, r in zip(report.attempts, recs))
              + f"; {run_wall:.1f} s [{card}]", flush=True)
    clean = runs["clean"][1][0]["losses"]
    rep, recs, _ = runs["recover"]
    assert [a.cause for a in rep.attempts] == ["crash"] * 2 + ["ok"], \
        rep.attempts
    assert all(a.returncodes[3] == 17 for a in rep.attempts[:2])
    assert [r["resumed"] for r in recs] == ["fresh", "elastic_step2.npz",
                                            "elastic_step2.npz"], recs
    assert "checkpoint_skipped" in recs[2]["events"], recs[2]
    # a killed attempt's rank 0 may finish the step rank 3 died after
    for r, first, upto in ((recs[0], 0, 2), (recs[1], 2, 4)):
        got = r["losses"]
        assert len(got) >= upto - first, r
        assert got == clean[first:first + len(got)], (r, clean)
    assert recs[2]["losses"] == clean[2:], (recs[2], clean)
    rep, recs, _ = runs["shrink"]
    assert [a.cause for a in rep.attempts] == ["resize", "ok"], rep.attempts
    assert [a.num_processes for a in rep.attempts] == [MESH_WORLD,
                                                       MESH_WORLD // 2]
    assert rep.attempts[0].resize == {"processes": MESH_WORLD // 2,
                                      "step": 4}
    # step 4's loss is not recorded: the resize exits inside its step
    assert recs[0]["losses"] == clean[:3], (recs[0], clean)
    assert "reshard_on_resume" in recs[1]["events"], recs[1]
    # the fixed run resumed from the uninterrupted run's step-4
    # checkpoint: the shrink's holds the same state, bit for bit
    ckpts = [np.load(os.path.join(root, tag, "ckpt", "elastic_step4.npz"))
             for tag in ("clean", "shrink")]
    with ckpts[0] as a, ckpts[1] as b:
        keys = [k for k in a.files if k != "meta:manifest"]
        assert sorted(keys) == sorted(k for k in b.files
                                      if k != "meta:manifest"), \
            (a.files, b.files)
        for k in keys:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    fixed = runs["fixed2"][1][0]
    assert recs[1]["losses"] == fixed["losses"], (recs[1], fixed)
    resizes = [e for e in events if e["event"] == "reshard"]
    assert [(e["old_devices"], e["new_devices"], e["step"])
            for e in resizes] == [(MESH_WORLD, MESH_WORLD // 2, 4)], resizes
    print(f"elastic: the kill (rank 3 at step 3) and the fallback past the "
          f"corrupt step-4 checkpoint recovered bit-equal to the "
          f"uninterrupted run (losses {clean}); the shrink to "
          f"{MESH_WORLD // 2} ranks through the supervisor bit-equal to "
          f"the fixed {MESH_WORLD // 2}-rank run from the step-4 "
          f"checkpoint ({fixed['losses']}; the two step-4 checkpoints "
          f"bit-equal); {wall:.1f} s for the {len(ELASTIC_CHAINS)} chains "
          f"side by side [{card}]")
    shutil.rmtree(root, ignore_errors=True)
    return {tag: round(r[2], 3) for tag, r in runs.items()}


# ----------------------------------------------------------------------
# A.9 (first half): the strategy search
# ----------------------------------------------------------------------
# the analytic searches (BERT-base and InceptionV3 at full width, every
# proposal priced by the H100 spec's roofline on the native engine) and
# the measured ones (each candidate partition of each op timed alone on
# the card with CUDA events, through the port's kernels: AlexNet whole,
# BERT-base at SEARCH_BERT_MEASURE_LAYERS of its layers), all for
# SEARCH_DEVICES devices.  SEARCH_MESH_RUNS: the four mesh ranks compile
# BERT-base with search_budget (each rank searches the same analytic
# objective) and train 2 steps on the searched strategy; the bf16 run is
# held to one rank by the L2 share, its float32 twin (2 layers) at
# MESH_RTOL
SEARCH_DEVICES = 4
SEARCH_BUDGET = 2000
SEARCH_MEASURE_BUDGET = 120
SEARCH_BERT_MEASURE_LAYERS = 2
SEARCH_MESH_RUNS = {"search_bert": ("bfloat16", BERT["num_layers"]),
                    "search_bert_f32": ("float32", 2)}
SEARCH_MESH_STEPS = 2
# (pool fwd, pool bwd, flash fwd, flash bwd, layernorm): the kernels each
# measured search must launch
SEARCH_MEASURE_KERNELS = {"alexnet": (0, 1), "bert": (2, 3, 4)}
# the searches' strategy digests by (model, layers, compute dtype), and
# the file the search phase exported BERT-base's strategy to (the mesh
# ranks' exports must equal it)
SEARCH_DIGESTS = {}
SEARCH_EXPORT = ""


def search_model(ft, name: str, layers=None, **cfg_kw):
    """The search phase's model, compiled on one device (no mesh, no
    parameters): BERT-base (bf16, batch 16, Adam 1e-4) at ``layers``
    layers, InceptionV3 (299 px, 1000 classes, batch 64, SGD 0.001 with
    momentum) or AlexNet (229 px, 10 classes, batch 64, SGD 0.01)."""
    from flexflow_tpu_torch.models import (build_alexnet,
                                           build_inception_v3,
                                           build_transformer)

    if name == "bert":
        cfg = ft.FFConfig(batch_size=BERT_BATCH, seed=SEED, **cfg_kw)
        arch = dict(BERT, num_layers=layers or BERT["num_layers"])
        model, _, logits = build_transformer(cfg, **arch)
        model.compile(ft.AdamOptimizer(alpha=1e-4), metrics=["accuracy"],
                      final_tensor=logits, verify="off")
        return model
    cfg = ft.FFConfig(batch_size=BATCH, seed=SEED, **cfg_kw)
    if name == "inception_v3":
        model, _, _ = build_inception_v3(cfg, 1000, 299)
        opt = ft.SGDOptimizer(lr=0.001, momentum=0.9)
    else:
        model, _, _ = build_alexnet(cfg, num_classes=10, image_size=229)
        opt = ft.SGDOptimizer(lr=0.01)
    model.compile(opt, metrics=["accuracy"], verify="off")
    return model


def search_run(model, budget: int):
    """One search for SEARCH_DEVICES devices through
    ``optimize_strategies`` (what compile calls) on the objective it
    builds; returns (strategies, mesh, simulator, stats, wall seconds)."""
    from flexflow_tpu_torch.search.mcmc import (optimize_strategies,
                                                search_simulator)

    sim = search_simulator(model, model.config, SEARCH_DEVICES)
    stats = {}
    t0 = time.perf_counter()
    best, mesh = optimize_strategies(model, model.config,
                                     num_devices=SEARCH_DEVICES,
                                     budget=budget, with_mesh=True,
                                     sim=sim, stats=stats)
    return best, mesh, sim, stats, time.perf_counter() - t0


def search_op_types(model, sim, card: str) -> dict:
    """Measure mode's times (forward + backward, every finite cached
    partition) against the H100 spec's analytic roofline on the same
    partitions, summed by op type."""
    from flexflow_tpu_torch.search.simulator import Simulator

    ana = Simulator(spec=sim.spec, num_devices=sim.num_devices,
                    use_native=False, flash_attention=sim.flash_attention,
                    compute_dtype=sim.compute_dtype, device=sim.device)
    ops = {op.name: op for op in model.layers}
    rows = {}
    for key, (fwd, bwd) in sim.measured().items():
        if not (math.isfinite(fwd) and math.isfinite(bwd)):
            continue
        op, dims = ops[key[0]], key[1]
        r = rows.setdefault(op.op_type.value, {
            "partitions": 0, "measured_ms": 0.0, "analytic_ms": 0.0})
        r["partitions"] += 1
        r["measured_ms"] += (fwd + bwd) * 1e3
        r["analytic_ms"] += (ana._analytic_time(op, dims, False)
                             + ana._analytic_time(op, dims, True)) * 1e3
    for r in rows.values():
        r["ratio"] = r["measured_ms"] / r["analytic_ms"]
    return rows


def search_phase(ft, card: str) -> dict:
    """The analytic searches (native engine asserted), then the measured
    ones with each kernel's launches counted; returns the launches by
    path (pool fwd, pool bwd, flash fwd, flash bwd, layernorm)."""
    global SEARCH_EXPORT
    import torch
    from flexflow_tpu_torch.ops import cuda_attention, cuda_norm, cuda_pool
    from flexflow_tpu_torch.search.cost_model import H100_SXM_SPEC
    from flexflow_tpu_torch.search.decompose import \
        data_parallel_strategies
    from flexflow_tpu_torch.strategy.proto import strategy_digest

    counters = (cuda_pool.max_pool_nhwc, cuda_pool.max_pool_nhwc_backward,
                cuda_attention.flash_attention_forward,
                cuda_attention.flash_attention_backward,
                cuda_norm.fused_layernorm)
    x = torch.randn((16, BERT["d_model"]), device="cuda",
                    dtype=torch.bfloat16)
    floor = time_ms(lambda t: cuda_norm.empty_launch(t), [x], 200)
    print(f"search spec: H100_SXM_SPEC kernel_launch "
          f"{H100_SXM_SPEC.kernel_launch * 1e3} ms, ici_latency "
          f"{H100_SXM_SPEC.ici_latency * 1e3} ms; this run's launch floor "
          f"(an empty kernel, 16 rows) {floor:.5f} ms [{card}]")
    out = {"launches": {}}
    for name in ("bert", "inception_v3"):
        model = search_model(ft, name)
        best, mesh, sim, st, wall = search_run(model, SEARCH_BUDGET)
        assert sim.backend == "native", sim.backend
        dp = sim.simulate(model.layers, data_parallel_strategies(
            model.layers, SEARCH_DEVICES), mesh_shape={"n": SEARCH_DEVICES})
        best_t = sim.simulate(model.layers, best, mesh_shape=mesh)
        digest = strategy_digest(best)
        SEARCH_DIGESTS[(name, BERT["num_layers"] if name == "bert"
                        else None, model.config.compute_dtype)] = digest
        if name == "bert":
            SEARCH_EXPORT = write_strategy("searched_bert_4dev.pb", best)
            print("search analytic bert: exported "
                  f"{os.path.relpath(SEARCH_EXPORT, HERE)}")
        print(f"search analytic {name}: best {best_t * 1e3:.6f} ms "
              f"simulated on {len(model.layers)} ops, mesh "
              f"{ {a: v for a, v in mesh.items() if v > 1} }, data "
              f"parallel {dp * 1e3:.6f} ms, session backend {sim.backend}, "
              f"{st['proposals']} proposals ({st['proposals'] / wall:.1f} "
              f"a second), {st['evaluations']} evaluations, {st['accepted']} "
              f"accepted, {wall:.3f} s wall, digest {digest} [{card}]")
        del model
    for name, layers in (("alexnet", None),
                         ("bert", SEARCH_BERT_MEASURE_LAYERS)):
        model = search_model(ft, name, layers, simulator_mode="measure")
        reset_counts(*counters)
        best, mesh, sim, st, wall = search_run(model, SEARCH_MEASURE_BUDGET)
        torch.cuda.synchronize()
        launches = [f.launches for f in counters]
        assert sim.measure and sim.backend == "native", sim.backend
        for i in SEARCH_MEASURE_KERNELS[name]:
            assert launches[i] > 0, (name, launches)
        rows = search_op_types(model, sim, card)
        out["launches"][f"search_measure_{name}"] = launches
        out[name] = rows
        print(f"search measure {name}: best "
              f"{st['best_trace'][-1][1] * 1e3:.6f} ms measured, mesh "
              f"{ {a: v for a, v in mesh.items() if v > 1} }, "
              f"measure cache {len(sim.measured())} partitions, "
              f"{st['proposals']} proposals, {wall:.3f} s wall, launches "
              f"{launches} (pool fwd, pool bwd, flash fwd, flash bwd, "
              f"layernorm) [{card}]")
        print(f"search measure {name} by op type (forward + backward ms "
              f"summed over the measured partitions, against the H100 "
              f"spec's roofline) [{card}]: " + json.dumps(rows))
        del model, sim
        torch.cuda.empty_cache()
    return out


# the calibration phase: the graphs harvested (search_model's), the
# partition degrees, best-of-N profile runs and iterations per op, the
# fit rows per dispatch harvest (batches of the model's batch), and the
# kernels each graph must launch while its ops are timed (pool fwd, pool
# bwd, flash fwd, flash bwd, layernorm)
CALIB_MODELS = ("alexnet", "bert", "inception_v3")
CALIB_DEGREES = (1, 2)
CALIB_SAMPLES = 1
CALIB_ITERS = 4
CALIB_FIT_BATCHES = 2
CALIB_KERNELS = {"alexnet": (0, 1), "bert": (2, 3, 4),
                 "inception_v3": (0, 1)}
CALIB_SEARCH_BENCH = dict(num_devices=16, steps=96, budget=200,
                          min_time_s=0.2)
CALIB_TABLE = os.path.join(HERE, "build", "calibration",
                           "h100_table.json")


def calib_data(model, rng):
    """CALIB_FIT_BATCHES batches of random inputs and labels for a
    calibration model: token rows and 2 classes for BERT-base, images
    and the model's classes for the CNNs."""
    import numpy as np

    n = CALIB_FIT_BATCHES * model.config.batch_size
    shape = model.input_tensors[0].shape
    if model.input_tensors[0].dtype == "int32":
        x = rng.integers(0, BERT["vocab_size"], (n,) + shape[1:]).astype(
            np.int32)
        classes = BERT["num_classes"]
    else:
        x = rng.standard_normal((n,) + shape[1:]).astype(np.float32)
        classes = model.layers[-1].outputs[0].shape[-1]
    return x, rng.integers(0, classes, (n, 1)).astype(np.int32)


def calib_optimizer(ft, name: str):
    """search_model's optimizer for ``name``."""
    if name == "bert":
        return ft.AdamOptimizer(alpha=1e-4)
    if name == "inception_v3":
        return ft.SGDOptimizer(lr=0.001, momentum=0.9)
    return ft.SGDOptimizer(lr=0.01)


def calibration_phase(ft, card: str) -> dict:
    """Harvest a CalibrationTable on the card, fit its step correction,
    save and reload it, sweep its error, search and bench on it and
    explain the calibrated strategy (see the module docstring, 17f);
    returns the kernels' launches by graph, harvest and sweep together
    (pool fwd, pool bwd, flash fwd, flash bwd, layernorm)."""
    import dataclasses

    import numpy as np
    import torch
    from flexflow_tpu_torch.analysis import (explain_report,
                                             validate_explain_json)
    from flexflow_tpu_torch.fflogger import silenced
    from flexflow_tpu_torch.ops import cuda_attention, cuda_norm, cuda_pool
    from flexflow_tpu_torch.search import calibration as calib
    from flexflow_tpu_torch.search.bench import bench_graph
    from flexflow_tpu_torch.search.cost_model import spec_for_device
    from flexflow_tpu_torch.search.decompose import \
        data_parallel_strategies
    from flexflow_tpu_torch.search.mcmc import (optimize_strategies,
                                                search_simulator)
    from flexflow_tpu_torch.strategy.proto import strategy_digest

    counters = (cuda_pool.max_pool_nhwc, cuda_pool.max_pool_nhwc_backward,
                cuda_attention.flash_attention_forward,
                cuda_attention.flash_attention_backward,
                cuda_norm.fused_layernorm)
    free_garbage()
    torch.cuda.empty_cache()
    kind = torch.cuda.get_device_name(0)
    table = calib.CalibrationTable(device_kind=calib.device_kind("cuda"),
                                   compute_dtype="bfloat16")
    assert table.device_kind == kind, (table.device_kind, kind)
    spec = spec_for_device()
    rng = np.random.default_rng(SEED)
    out = {"launches": {}}
    layers, data = {}, {}
    # 1. every op timed alone at degrees 1 and 2
    for name in CALIB_MODELS:
        model = search_model(ft, name)
        layers[name] = model.layers
        skipped = []
        reset_counts(*counters)
        t0 = time.perf_counter()
        n = calib.harvest_ops(table, model.layers, compute_dtype="bfloat16",
                              iters=CALIB_ITERS, degrees=CALIB_DEGREES,
                              samples=CALIB_SAMPLES, device="cuda",
                              skipped=skipped)
        torch.cuda.synchronize()
        launches = [f.launches for f in counters]
        wall = time.perf_counter() - t0
        print(f"calibration harvest {name}: {len(model.layers)} ops at "
              f"degrees {list(CALIB_DEGREES)}, {n} measurements, table "
              f"{len(table.ops)} entries, {len(skipped)} skipped, "
              f"launches {launches} (pool fwd, pool bwd, flash fwd, flash "
              f"bwd, layernorm), {wall:.3f} s wall [{card}]")
        assert not skipped, skipped
        for i in CALIB_KERNELS[name]:
            assert launches[i] > 0, (name, launches)
        out["launches"][name] = launches
        # 2. the dispatch harvest through fit's epoch events
        data[name] = calib_data(model, rng)
        model.init_layers(seed=SEED)
        with silenced("ff"):
            ms = calib.harvest_train_dispatch(table, name, model,
                                              *data[name])
        assert ms is not None and ms > 0, ms
        print(f"calibration dispatch {name}: fit's dispatch_ms {ms:.4f} ms "
              f"a dispatch (the host's wall around one step's enqueue), "
              f"batch {model.config.batch_size} [{card}]")
        del model
        free_garbage()
        torch.cuda.empty_cache()
    table.step_correction = calib._fit_dispatch_correction(
        table, layers, device="cuda")
    assert table.step_correction is not None
    print(f"calibration step correction over {len(layers)} models: "
          f"{json.dumps(table.step_correction)} [{card}]")
    # 3. save, validate, reload
    os.makedirs(os.path.dirname(CALIB_TABLE), exist_ok=True)
    digest = table.save(CALIB_TABLE)
    errs = calib.validate_file(CALIB_TABLE)
    again = calib.CalibrationTable.load(CALIB_TABLE)
    print(f"calibration table {os.path.relpath(CALIB_TABLE, HERE)}: "
          f"{len(table.ops)} op entries, {len(table.dispatch)} dispatch "
          f"entries, digest {digest}, reloaded {again.digest}, "
          f"validate_file {errs}, device_kind {again.device_kind!r} "
          f"[{card}]")
    assert errs == [] and again.digest == digest
    assert again.device_kind == kind
    out["digest"] = digest
    # 4. the error sweep: fresh per-op times and a synchronized fit
    ests = {"table": calib.TableEstimator(again),
            "ridge": calib.RidgeEstimator(again)}
    rows = {e: [] for e in ests}
    for name in CALIB_MODELS:
        model = search_model(ft, name)
        reset_counts(*counters)
        with silenced("ff"):
            by_est = calib.bench_model_rows(
                name, model, *data[name], ests, again, spec,
                compute_dtype="bfloat16", iters=CALIB_ITERS,
                samples=CALIB_SAMPLES, seed=SEED,
                optimizer=calib_optimizer(ft, name))
        torch.cuda.synchronize()
        out["launches"][name] = [a + f.launches for a, f in
                                 zip(out["launches"][name], counters)]
        disp = next(r["measured_ms"] for k, r in again.dispatch.items()
                    if k.startswith(f"train|{name}|"))
        for e, row in by_est.items():
            rows[e].append(row)
            p, t = row["per_op"], row["end_to_end"]
            print(f"calibration bench {name} {e}: per-op MAPE analytic "
                  f"{p['mape_analytic']} calibrated {p['mape_calibrated']} "
                  f"over {p['n_measured']} ops; measured "
                  f"{t['measured_ms_per_step']} ms a step (synchronized) "
                  f"against fit's dispatch_ms {disp:.4f}; simulated "
                  f"analytic {t['sim_analytic_ms']} ms (APE "
                  f"{t['ape_analytic']}), calibrated "
                  f"{t['sim_calibrated_ms']} ms (APE "
                  f"{t['ape_calibrated']}) [{card}]")
        del model
        free_garbage()
        torch.cuda.empty_cache()
    for e, r in rows.items():
        payload = {"kind": calib.BENCH_KIND, "version": calib.SCHEMA_VERSION,
                   "bench": "calibrate-bench", "device_kind": kind,
                   "calibration_digest": digest, "estimator": e,
                   "step_correction": again.step_correction, "models": r}
        assert calib.validate_bench(payload) == [], e
        print(f"calibration bench {e} [{card}]: " + json.dumps(payload))
    out["bench"] = rows
    # 5. BERT-base searched for 4 devices on the table's objective
    model = search_model(ft, "bert", calibration_file=CALIB_TABLE,
                         cost_estimator="table")
    sim = search_simulator(model, model.config, SEARCH_DEVICES)
    assert sim.estimator is not None and sim.estimator.name == "table"
    ana = search_simulator(model, dataclasses.replace(
        model.config, calibration_file="", cost_estimator="auto"),
        SEARCH_DEVICES)
    stats = {}
    t0 = time.perf_counter()
    best, mesh = optimize_strategies(model, model.config,
                                     num_devices=SEARCH_DEVICES,
                                     budget=SEARCH_BUDGET, with_mesh=True,
                                     sim=sim, stats=stats)
    wall = time.perf_counter() - t0
    assert sim.backend == "native", sim.backend
    dp = data_parallel_strategies(model.layers, SEARCH_DEVICES)
    dp_mesh = {"n": SEARCH_DEVICES}
    got = {"best_table_ms": sim.simulate(model.layers, best,
                                         mesh_shape=mesh) * 1e3,
           "best_analytic_ms": ana.simulate(model.layers, best,
                                            mesh_shape=mesh) * 1e3,
           "dp_table_ms": sim.simulate(model.layers, dp,
                                       mesh_shape=dp_mesh) * 1e3,
           "dp_analytic_ms": ana.simulate(model.layers, dp,
                                          mesh_shape=dp_mesh) * 1e3}
    shape = {a: v for a, v in mesh.items() if v > 1}
    print(f"calibration search bert: best mesh {shape}, simulated "
          f"{got['best_table_ms']:.6f} ms under the table "
          f"({got['best_analytic_ms']:.6f} under the analytic roofline), "
          f"data parallel {got['dp_table_ms']:.6f} ms under the table "
          f"({got['dp_analytic_ms']:.6f} analytic), session backend "
          f"{sim.backend}, {stats['proposals']} proposals in {wall:.3f} s, "
          f"digest {strategy_digest(best)} [{card}]")
    out["search"] = dict(got, mesh=shape, digest=strategy_digest(best))
    # 6. one search-bench row on the table
    row = bench_graph("transformer", estimator=ests["table"],
                      **CALIB_SEARCH_BENCH)
    assert row["estimator"] == "table"
    assert row["calibration_digest"] == digest
    print(f"calibration search-bench transformer ({row['num_ops']} ops, "
          f"{row['num_devices']} devices, table): "
          f"{row['proposals_per_sec_delta']} proposals a second delta "
          f"against {row['proposals_per_sec_full']} full (x"
          f"{row['speedup']}), backend {row['backend']}, best "
          f"{row['best_simulated_ms']} ms, mesh {row['best_mesh']} "
          f"[{card}]")
    # 7. the explain report of the calibrated strategy
    rep = explain_report("bert", model.layers, best, mesh_shape=shape,
                         num_devices=SEARCH_DEVICES)
    errs = validate_explain_json(rep)
    tl = rep["memory_timeline"]
    print(f"calibration explain bert on {rep['mesh']}: comm plan "
          f"{rep['comm_plan_digest']} ({rep['comm_plan']['totals']}), "
          f"peak {tl['peak_bytes'] / 1e9:.3f} GB against "
          f"hbm_capacity_bytes {tl['hbm_capacity_bytes'] / 1e9:.1f} GB, "
          f"{len(rep['predicted_fallbacks'])} predicted fallbacks, "
          f"validate_explain_json {errs} [{card}]")
    assert errs == [], errs
    del model, sim, ana
    free_garbage()
    return out


def mesh_search_rank(ft, name: str, rank: int, workdir: str, counters,
                     card: str) -> dict:
    """A search run on one rank: BERT-base (or its float32 twin)
    compiled with search_budget on the process group's devices, the
    strategy exported, SEARCH_MESH_STEPS steps."""
    import numpy as np
    import torch
    from flexflow_tpu_torch.models import build_transformer
    from flexflow_tpu_torch.strategy.proto import strategy_digest

    dtype, layers = SEARCH_MESH_RUNS[name]
    arch = dict(BERT, num_layers=layers)
    cfg = ft.FFConfig(batch_size=BERT_BATCH, seed=SEED, compute_dtype=dtype,
                      search_budget=SEARCH_BUDGET,
                      export_strategy_file=os.path.join(
                          workdir, f"{name}-rank{rank}.pb"))
    model, _, logits = build_transformer(cfg, **arch)
    t0 = time.perf_counter()
    model.compile(ft.AdamOptimizer(alpha=1e-4), metrics=["accuracy"],
                  final_tensor=logits)
    compile_s = time.perf_counter() - t0
    model.init_layers(seed=SEED)
    if rank == 0:
        np.savez(os.path.join(workdir, f"{name}-init.npz"),
                 **mesh_state(model, False))
    else:
        mesh_state(model, False)
    rng = np.random.default_rng(SEED)
    batch = (rng.integers(0, arch["vocab_size"],
                          (BERT_BATCH, arch["seq_len"])).astype(np.int32),
             rng.integers(0, arch["num_classes"],
                          (BERT_BATCH, 1)).astype(np.int32))
    losses, launches, walls = [], [], []
    for _ in range(SEARCH_MESH_STEPS):
        reset_counts(*counters)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(model.train_batch(*batch)))
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        launches.append([f.launches for f in counters])
    state = mesh_state(model, dtype == "bfloat16")
    if rank == 0:
        np.savez(os.path.join(workdir, f"{name}-final.npz"), **state)
    mesh = {a: s for a, s in model.mesh.sizes.items() if s > 1}
    digest = strategy_digest({op.name: op.parallel_config
                              for op in model.layers})
    print(f"mesh {name} rank {rank}: compile with search_budget "
          f"{SEARCH_BUDGET} in {compile_s:.3f} s, searched mesh {mesh}, "
          f"digest {digest}, losses {losses}, launches a step "
          f"{launches} (pool fwd, pool bwd, flash fwd, flash bwd, "
          f"layernorm), step wall {[round(w, 3) for w in walls]} ms "
          f"[{card}]", flush=True)
    del model
    torch.cuda.empty_cache()
    return {"losses": losses, "launches": launches, "wall_ms": walls,
            "mesh": mesh, "digest": digest, "compile_s": compile_s}


def mesh_search_check(ft, name: str, workdir: str, ranks, card: str):
    """Every rank searched the same strategy (the main process's search
    of the same graph and objective, and one exported file), and the
    run is held to one rank: the same model, no strategy, the same
    parameters and batch."""
    import numpy as np
    import torch
    from flexflow_tpu_torch.models import build_transformer
    from flexflow_tpu_torch.strategy.proto import strategy_digest

    dtype, layers = SEARCH_MESH_RUNS[name]
    recs = [r[name] for r in ranks]
    digests = {r["digest"] for r in recs}
    files = set()
    for r in range(MESH_WORLD):
        with open(os.path.join(workdir, f"{name}-rank{r}.pb"), "rb") as f:
            files.add(f.read())
    key = ("bert", layers, dtype)
    if key not in SEARCH_DIGESTS:
        model = search_model(ft, "bert", layers, compute_dtype=dtype)
        SEARCH_DIGESTS[key] = strategy_digest(search_run(
            model, SEARCH_BUDGET)[0])
        del model
    assert len(digests) == 1 and len(files) == 1, (digests, len(files))
    assert digests == {SEARCH_DIGESTS[key]}, (digests, SEARCH_DIGESTS[key])
    if dtype == "bfloat16":   # the search phase's export, byte for byte
        assert SEARCH_EXPORT, "the search phase exported no strategy"
        with open(SEARCH_EXPORT, "rb") as f:
            assert files == {f.read()}, SEARCH_EXPORT
    arch = dict(BERT, num_layers=layers)
    cfg = ft.FFConfig(batch_size=BERT_BATCH, seed=SEED, compute_dtype=dtype)
    model, _, logits = build_transformer(cfg, **arch)
    model.compile(ft.AdamOptimizer(alpha=1e-4), metrics=["accuracy"],
                  final_tensor=logits)
    model.init_layers(seed=SEED)
    with np.load(os.path.join(workdir, f"{name}-init.npz")) as z:
        init = {k: z[k] for k in z.files}
    mine = mesh_state(model, False)
    for k, v in init.items():   # both drew them from SEED
        np.testing.assert_array_equal(v, mine[k], err_msg=k)
    rng = np.random.default_rng(SEED)
    batch = (rng.integers(0, arch["vocab_size"],
                          (BERT_BATCH, arch["seq_len"])).astype(np.int32),
             rng.integers(0, arch["num_classes"],
                          (BERT_BATCH, 1)).astype(np.int32))
    losses = [float(model.train_batch(*batch))
              for _ in range(SEARCH_MESH_STEPS)]
    one = mesh_state(model, dtype == "bfloat16")
    del model
    torch.cuda.empty_cache()
    with np.load(os.path.join(workdir, f"{name}-final.npz")) as z:
        got = {k: z[k] for k in z.files}
    print(f"mesh {name}: every rank searched mesh {recs[0]['mesh']}, "
          f"digest {recs[0]['digest']} (the main process's search: "
          f"{SEARCH_DIGESTS[key]}), one exported file [{card}]")
    hold_mesh_state(name, recs[0]["mesh"], dtype, recs[0]["losses"],
                    losses, one, got, init, card)


# ----------------------------------------------------------------------
# A.11, the frontends: the nn_compat module API, keras and the runner
# ----------------------------------------------------------------------
# (a) examples/python/native/alexnet_torch.py through nn_compat at its
# width (229 px, batch 64, 10 classes, bf16): fit over FRONT_FIT_BATCHES
# batches, then predict; its float32 twin, the same graph by FFModel's
# builder calls from the same weights, FRONT_TWIN_STEPS SGD steps within
# FRONT_TWIN_RTOL (bit-equal expected: the same ops in the same order).
# (b) examples/python/keras/func_cifar10_alexnet.py (3 x 32 x 32, batch
# 64) on keras.datasets.cifar10 (the synthetic fallback: no file on the
# card's machine): fit over FRONT_KERAS_STEPS batches, then evaluate;
# its two pools (FRONT_KERAS_POOLS) held bit-equal to the plain version.
# (c) a keras residual block at BERT-base's width, FRONT_LN_ROWS rows:
# the LayerNorm kernel once a forward.  (d) the runner in subprocesses,
# started first and run beside (a)-(c): (b) for FRONT_RUNNER_STEPS steps
# under `-b 64 -e 1`, and lint and explain, device-free
FRONT_FIT_BATCHES = 4
FRONT_TWIN_STEPS = 2
FRONT_TWIN_RTOL = 1e-6
FRONT_KERAS_STEPS = 4
FRONT_KERAS_POOLS = [((64, 8, 8), ((2, 2), (2, 2), (0, 0))),
                     ((192, 4, 4), ((2, 2), (2, 2), (0, 0)))]
FRONT_LN_ROWS = 512
FRONT_LN_STEPS = 2
FRONT_RUNNER_STEPS = 2
FRONT_TIMEOUT = 300


def front_nn_alexnet(nn):
    """alexnet_torch.py's AlexNet over the ``nn`` shim."""

    class AlexNet(nn.Module):
        def __init__(self, config=None):
            super().__init__(config)
            self.conv2_1 = nn.Conv2d(3, 64, kernel_size=11, stride=4,
                                     padding=2)
            self.relu_1 = nn.ReLU()
            self.maxpool2d_1 = nn.MaxPool2d(kernel_size=3, stride=2)
            self.conv2_2 = nn.Conv2d(64, 192, kernel_size=5, stride=1,
                                     padding=2)
            self.relu_2 = nn.ReLU()
            self.maxpool2d_2 = nn.MaxPool2d(kernel_size=3, stride=2)
            self.conv2_3 = nn.Conv2d(192, 384, kernel_size=3, stride=1,
                                     padding=1)
            self.relu_3 = nn.ReLU()
            self.conv2_4 = nn.Conv2d(384, 256, kernel_size=3, stride=1,
                                     padding=1)
            self.relu_4 = nn.ReLU()
            self.conv2_5 = nn.Conv2d(256, 256, kernel_size=3, stride=1,
                                     padding=1)
            self.relu_5 = nn.ReLU()
            self.maxpool2d_3 = nn.MaxPool2d(kernel_size=3, stride=2)
            self.flat = nn.Flatten()
            self.linear_1 = nn.Linear(256 * 6 * 6, 4096)
            self.relu_6 = nn.ReLU()
            self.linear_2 = nn.Linear(4096, 4096)
            self.relu_7 = nn.ReLU()
            self.linear_3 = nn.Linear(4096, 10)
            self.softmax = nn.Softmax()

        def forward(self, x):
            x = self.maxpool2d_1(self.relu_1(self.conv2_1(x)))
            x = self.maxpool2d_2(self.relu_2(self.conv2_2(x)))
            x = self.relu_3(self.conv2_3(x))
            x = self.relu_4(self.conv2_4(x))
            x = self.maxpool2d_3(self.relu_5(self.conv2_5(x)))
            x = self.flat(x)
            x = self.relu_6(self.linear_1(x))
            x = self.relu_7(self.linear_2(x))
            return self.softmax(self.linear_3(x))

    return AlexNet


def front_builder_alexnet(ft, cfg):
    """The nn_compat AlexNet's graph by FFModel's builder calls, op for
    op, each op named as the shim names it (its attribute)."""
    m = ft.FFModel(cfg)
    t = m.create_tensor((cfg.batch_size, 3, 229, 229), name="input")
    convs = [("conv2_1", 64, 11, 4, 2, "maxpool2d_1"),
             ("conv2_2", 192, 5, 1, 2, "maxpool2d_2"),
             ("conv2_3", 384, 3, 1, 1, None),
             ("conv2_4", 256, 3, 1, 1, None),
             ("conv2_5", 256, 3, 1, 1, "maxpool2d_3")]
    for i, (name, out, k, stride, pad, pool) in enumerate(convs):
        t = m.conv2d(t, out, k, k, stride, stride, pad, pad, name=name)
        t = m.relu(t, name=f"relu_{i + 1}")
        if pool:
            t = m.pool2d(t, 3, 3, 2, 2, 0, 0, pool_type="max", name=pool)
    t = m.flat(t, name="flat")
    t = m.relu(m.dense(t, 4096, name="linear_1"), name="relu_6")
    t = m.relu(m.dense(t, 4096, name="linear_2"), name="relu_7")
    return m, m.softmax(m.dense(t, 10, name="linear_3"), name="softmax")


def front_keras_cifar(K):
    """func_cifar10_alexnet.py's functional model over the ``K`` keras
    package (the runner's script builds it too)."""
    inp = K.Input((3, 32, 32))
    t = K.Conv2D(64, (11, 11), strides=(4, 4), padding=(5, 5),
                 activation="relu")(inp)
    t = K.MaxPooling2D((2, 2))(t)
    t = K.Conv2D(192, (5, 5), padding=(2, 2), activation="relu")(t)
    t = K.MaxPooling2D((2, 2))(t)
    t = K.Conv2D(256, (3, 3), padding="same", activation="relu")(t)
    t = K.Flatten()(t)
    t = K.Dense(512, activation="relu")(t)
    t = K.Dense(512, activation="relu")(t)
    out = K.Activation("softmax")(K.Dense(10)(t))
    return K.Model(inp, out)


def front_cifar_data(K, n: int, split: int = 0):
    """The first ``n`` rows of cifar10's train (0) or test (1) split as
    the example feeds them: float32 in [0, 1], int32 (n, 1) labels."""
    import numpy as np
    x, y = K.datasets.cifar10.load_data()[split]
    return (x[:n].astype(np.float32) / 255.0,
            y[:n].reshape(-1, 1).astype(np.int32))


FRONT_RUNNER_SCRIPT = """\
import json
import sys

sys.path.insert(0, {here!r})
import chip_smoke as s
import flexflow_tpu_torch as ft
from flexflow_tpu_torch import keras
from flexflow_tpu_torch.ops import cuda_pool

cfg = ft.get_default_config()
x, y = s.front_cifar_data(keras, cfg.batch_size * s.FRONT_RUNNER_STEPS)
model = s.front_keras_cifar(keras)
model.compile(keras.SGD(learning_rate=0.01),
              loss="sparse_categorical_crossentropy", metrics=["accuracy"])
fwd, bwd = cuda_pool.max_pool_nhwc, cuda_pool.max_pool_nhwc_backward
s.reset_counts(fwd, bwd)
pm = model.fit(x, y, epochs=cfg.epochs, verbose=0)
print("FRONT_RUNNER " + json.dumps({{
    "batch_size": model.ffconfig.batch_size, "epochs": cfg.epochs,
    "device": model.ffmodel.device.type, "pool_fwd": fwd.launches,
    "pool_bwd": bwd.launches, "steps": model.ffmodel._step,
    "accuracy": pm.accuracy}}))
"""


def front_start_runner(workdir: str) -> dict:
    """Start the runner's three subprocesses (the script, lint,
    explain), their output to files in ``workdir``."""
    script = os.path.join(workdir, "front_runner.py")
    with open(script, "w") as f:
        f.write(FRONT_RUNNER_SCRIPT.format(here=HERE))
    cli = [sys.executable, "-m", "flexflow_tpu_torch.cli"]
    cmds = {"script": cli + [script, "-b", str(BATCH), "-e", "1"],
            "lint": cli + ["lint", "--model", "alexnet", "--json"],
            "explain": cli + ["explain", "--model", "transformer",
                              "--mesh", "n=4", "--json"]}
    procs = {}
    for name, cmd in cmds.items():
        out = open(os.path.join(workdir, f"{name}.out"), "w")
        err = open(os.path.join(workdir, f"{name}.err"), "w")
        procs[name] = (subprocess.Popen(cmd, cwd=HERE, stdout=out,
                                        stderr=err), out, err,
                       time.perf_counter())
    return procs


def front_finish_runner(procs, workdir: str, card: str) -> dict:
    """Wait for the runner's subprocesses and check what each printed;
    returns the script's record."""
    outs = {}
    for name, (proc, out, err, t0) in procs.items():
        rc = proc.wait(timeout=FRONT_TIMEOUT)
        out.close()
        err.close()
        with open(os.path.join(workdir, f"{name}.out")) as f:
            text = f.read()
        with open(os.path.join(workdir, f"{name}.err")) as f:
            errtext = f.read()
        assert rc == 0, (name, rc, errtext[-3000:])
        outs[name] = (text, time.perf_counter() - t0)
    from flexflow_tpu_torch.analysis import validate_explain_json
    line = [ln for ln in outs["script"][0].splitlines()
            if ln.startswith("FRONT_RUNNER ")]
    assert len(line) == 1, outs["script"][0][-3000:]
    rec = json.loads(line[0][len("FRONT_RUNNER "):])
    steps = FRONT_RUNNER_STEPS
    assert rec["batch_size"] == BATCH and rec["epochs"] == 1, rec
    assert rec["device"] == "cuda" and rec["steps"] == steps, rec
    assert (rec["pool_fwd"], rec["pool_bwd"]) == (2 * steps, 2 * steps), rec
    lint = json.loads(outs["lint"][0])
    assert set(lint) == {"diagnostics", "counts"}, lint
    explain = json.loads(outs["explain"][0])
    assert {a: n for a, n in explain["mesh"].items() if n > 1} == {
        "n": 4}, explain["mesh"]
    assert validate_explain_json(explain) == [], "explain payload"
    # each subprocess's seconds: from its start to this check, which
    # waits for (a)-(c) first
    print(f"frontends runner: python -m flexflow_tpu_torch.cli "
          f"front_runner.py -b {BATCH} -e 1 exit 0 (done within "
          f"{outs['script'][1]:.1f} s of its start): the script's config "
          f"batch {rec['batch_size']}, epochs {rec['epochs']}, device "
          f"{rec['device']}, {rec['steps']} steps, pool launches "
          f"{rec['pool_fwd']} forward and {rec['pool_bwd']} backward "
          f"(2 + 2 a step); lint --model alexnet --json exit 0 (within "
          f"{outs['lint'][1]:.1f} s; {len(lint['diagnostics'])} "
          f"diagnostics), explain --model transformer --mesh n=4 --json "
          f"exit 0 (within {outs['explain'][1]:.1f} s; payload valid, "
          f"comm digest {explain['comm_plan_digest']}) [{card}]")
    return rec


def front_params(core) -> dict:
    return {p.name: core.get_weights(p.name) for p in core.parameters}


def front_nn_twin(ft, AlexNet, card: str) -> dict:
    """The nn_compat AlexNet in float32 against its builder-call twin
    from the same weights: FRONT_TWIN_STEPS SGD steps, losses and every
    parameter within FRONT_TWIN_RTOL (of the parameter's largest
    magnitude), cuDNN deterministic."""
    import numpy as np
    import torch

    def cfg():
        return ft.FFConfig(batch_size=BATCH, compute_dtype="float32",
                           seed=SEED)

    with deterministic_cudnn():
        net = AlexNet(cfg())
        net(net.create_input((BATCH, 3, 229, 229)))
        net.compile(ft.SGDOptimizer(lr=0.01),
                    ft.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY, [])
        twin, out = front_builder_alexnet(ft, cfg())
        twin.compile(ft.SGDOptimizer(lr=0.01),
                     ft.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY, [],
                     final_tensor=out)
        twin.init_layers(seed=SEED + 1)
        shim = net.ffmodel
        assert ([(op.name, op.op_type) for op in twin.layers]
                == [(op.name, op.op_type) for op in shim.layers])
        for name, v in front_params(shim).items():
            twin.set_weights(name, v)
        xs, y = ft.synthetic_dataset(BATCH * FRONT_TWIN_STEPS,
                                     [(3, 229, 229)], (1,),
                                     num_classes=10, seed=SEED + 1)
        losses = []
        for i in range(FRONT_TWIN_STEPS):
            sl = slice(i * BATCH, (i + 1) * BATCH)
            losses.append((float(shim.train_batch(xs[0][sl], y[sl])),
                           float(twin.train_batch(xs[0][sl], y[sl]))))
        torch.cuda.synchronize()
        a, b = front_params(shim), front_params(twin)
    rel = max(float(np.abs(a[k] - b[k]).max()
                    / max(float(np.abs(b[k]).max()), 1e-30)) for k in a)
    loss_rel = max(abs(x - w) / max(abs(w), 1e-30) for x, w in losses)
    bit = (all(np.array_equal(a[k], b[k]) for k in a)
           and all(x == w for x, w in losses))
    print(f"frontends f32 AlexNet: nn_compat against its builder-call twin "
          f"({len(shim.layers)} ops, {len(a)} parameters), "
          f"{FRONT_TWIN_STEPS} SGD steps: losses {losses}, largest "
          f"relative difference of a loss {loss_rel:.3g} and of a "
          f"parameter {rel:.3g} (limit {FRONT_TWIN_RTOL}), bit-equal "
          f"{bit} [{card}]")
    assert loss_rel <= FRONT_TWIN_RTOL and rel <= FRONT_TWIN_RTOL, \
        (losses, rel)
    del net, twin, shim
    free_garbage()
    return {"bit_equal": bit, "rel": rel}


def front_nn_path(ft, cuda_pool, card: str) -> dict:
    """(a): the nn_compat AlexNet at full width on the card."""
    import numpy as np
    import torch
    from flexflow_tpu_torch.nn_compat import nn

    AlexNet = front_nn_alexnet(nn)
    net = AlexNet(ft.FFConfig(batch_size=BATCH, seed=SEED))
    net(net.create_input((BATCH, 3, 229, 229)))
    net.compile(ft.SGDOptimizer(lr=0.001),
                ft.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
                [ft.METRICS_ACCURACY])
    core = net.ffmodel
    assert core.device.type == "cuda" and \
        core.resolved_conv_layout == "nhwc", (core.device,
                                              core.resolved_conv_layout)
    xs, y = ft.synthetic_dataset(BATCH * FRONT_FIT_BATCHES,
                                 [(3, 229, 229)], (1,), num_classes=10,
                                 seed=SEED)
    fwd, bwd = cuda_pool.max_pool_nhwc, cuda_pool.max_pool_nhwc_backward
    reset_counts(fwd, bwd)
    t0 = time.perf_counter()
    pm = net.fit(xs[0], y, epochs=1, verbose=False)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    fit_counts = (fwd.launches, bwd.launches)
    preds = net.predict(xs[0][:BATCH])
    counts = (fwd.launches, bwd.launches)
    losses = core.last_epoch_losses
    print(f"frontends nn_compat AlexNet (229 px, batch {BATCH}, bf16): fit "
          f"over {FRONT_FIT_BATCHES} batches in {fit_s:.3f} s, losses "
          f"{[round(float(v), 4) for v in losses]}, accuracy "
          f"{pm.accuracy:.4f}; pool launches fit {fit_counts[0]} forward "
          f"+ {fit_counts[1]} backward (3 + 3 a step), predict "
          f"{counts[0] - fit_counts[0]} forward; predict "
          f"{tuple(preds.shape)}, rows sum to "
          f"{float(preds.sum(1).min()):.4f}-{float(preds.sum(1).max()):.4f}"
          f" [{card}]")
    assert fit_counts == (3 * FRONT_FIT_BATCHES, 3 * FRONT_FIT_BATCHES)
    assert counts == (3 * (FRONT_FIT_BATCHES + 1), 3 * FRONT_FIT_BATCHES)
    assert preds.shape == (BATCH, 10) and np.isfinite(preds).all()
    assert np.allclose(preds.sum(1), 1.0, atol=2e-2)
    assert len(losses) == FRONT_FIT_BATCHES and np.isfinite(losses).all()
    del net, core
    free_garbage()
    twin = front_nn_twin(ft, AlexNet, card)
    return {"fwd": counts[0], "bwd": counts[1], "twin": twin}


def pool_checks(cuda_pool, gen, pools, label: str) -> tuple:
    """The pool kernels at ``pools`` ((C, H, W), (k, s, p)) at batch
    BATCH, bf16 and f32, against the plain version, forward and
    backward, bit for bit; returns the largest errors (0.0)."""
    import torch
    err_f = err_b = 0.0
    for (c, h, w), (k, s, p) in pools:
        for dtype in (torch.bfloat16, torch.float32):
            x = rand_input((BATCH, c, h, w), dtype, gen)
            y = cuda_pool.max_pool_nhwc(x, k, s, p)
            ref = cuda_pool.max_pool_nhwc_reference(x, k, s, p)
            name = f"{label} {h}x{w}x{c} {str(dtype)[6:]}"
            err_f = max(err_f, assert_bit_equal(y, ref, name))
            oh, ow = cuda_pool.out_hw(h, w, k, s, p)
            g = rand_input((BATCH, c, oh, ow), dtype, gen)
            with plain_refused(cuda_pool):
                dx = cuda_pool.max_pool_nhwc_backward(x, g, k, s, p)
                torch.cuda.synchronize()
            dref = cuda_pool.max_pool_nhwc_backward_reference(x, g, k, s, p)
            err_b = max(err_b, assert_bit_equal(dx, dref,
                                                f"{name} backward"))
            print(f"kernel == plain (bit-equal), forward and backward: "
                  f"{name} (batch {BATCH}) k={k} s={s} p={p}")
    return err_f, err_b


def front_keras_path(ft, cuda_pool, gen, card: str) -> dict:
    """(b): the keras functional CIFAR-10 AlexNet on the card."""
    import numpy as np
    from flexflow_tpu_torch import keras

    err_f, err_b = pool_checks(cuda_pool, gen, FRONT_KERAS_POOLS,
                               "frontends keras")
    # cifar10 warns that it falls back to its synthetic set
    x, y = front_cifar_data(keras, BATCH * FRONT_KERAS_STEPS)
    xt, yt = front_cifar_data(keras, 8 * BATCH, split=1)
    model = front_keras_cifar(keras)
    model.compile(keras.SGD(learning_rate=0.01),
                  loss="sparse_categorical_crossentropy",
                  metrics=["accuracy"],
                  config=ft.FFConfig(batch_size=BATCH, seed=SEED))
    fwd, bwd = cuda_pool.max_pool_nhwc, cuda_pool.max_pool_nhwc_backward
    reset_counts(fwd, bwd)
    pm = model.fit(x, y, epochs=1, verbose=0)
    fit_counts = (fwd.launches, bwd.launches)
    fit_losses = model.ffmodel.last_epoch_losses
    loss, epm = model.evaluate(xt, yt)
    counts = (fwd.launches, bwd.launches)
    evals = -(-len(xt) // BATCH)
    print(f"frontends keras CIFAR-10 AlexNet (3x32x32, batch {BATCH}, "
          f"bf16, the synthetic cifar10): fit {FRONT_KERAS_STEPS} steps, "
          f"losses {[round(float(v), 4) for v in fit_losses]}, accuracy "
          f"{pm.accuracy:.4f}; evaluate {len(xt)} rows: loss "
          f"{loss:.4f}, accuracy {epm.accuracy:.4f}; pool launches fit "
          f"{fit_counts[0]} + {fit_counts[1]} (2 + 2 a step), evaluate "
          f"{counts[0] - fit_counts[0]} forward [{card}]")
    assert fit_counts == (2 * FRONT_KERAS_STEPS, 2 * FRONT_KERAS_STEPS)
    assert counts == (2 * (FRONT_KERAS_STEPS + evals),
                      2 * FRONT_KERAS_STEPS), counts
    assert np.isfinite(loss) and np.isfinite(fit_losses).all()
    summary = model.summary().splitlines()
    assert summary[-1].startswith("total parameters: "), summary
    del model
    free_garbage()
    return {"fwd": counts[0], "bwd": counts[1], "err_fwd": err_f,
            "err_bwd": err_b}


def front_ln_path(ft, counters, card: str) -> dict:
    """(c): a keras residual block at BERT-base's width: the LayerNorm
    kernel held against its plain version at (FRONT_LN_ROWS, 768), then
    one launch a forward through fit and predict."""
    import numpy as np
    import torch
    from flexflow_tpu_torch import keras
    from flexflow_tpu_torch.ops import cuda_norm

    d = BERT["d_model"]
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    x = torch.randn((FRONT_LN_ROWS, d), generator=gen, device="cuda").to(
        torch.bfloat16)
    res = torch.randn((FRONT_LN_ROWS, d), generator=gen,
                      device="cuda").to(torch.bfloat16)
    scale = 1 + 0.1 * torch.randn(d, generator=gen, device="cuda")
    bias = 0.1 * torch.randn(d, generator=gen, device="cuda")
    err = max(ln_check(cuda_norm, x, None, scale, bias,
                       " (frontends keras block)"),
              ln_check(cuda_norm, x, res, scale, bias,
                       " (frontends keras block)"))
    inp = keras.Input((d,))
    t = keras.Dense(BERT["d_ff"], activation="relu")(inp)
    t = keras.Dense(d)(t)
    t = keras.LayerNormalization()(keras.Add()([t, inp]))
    model = keras.Model(inp, keras.Dense(2)(t))
    model.compile(keras.SGD(learning_rate=0.01),
                  loss="sparse_categorical_crossentropy",
                  metrics=["accuracy"],
                  config=ft.FFConfig(batch_size=FRONT_LN_ROWS, seed=SEED))
    rng = np.random.default_rng(SEED)
    xs = rng.standard_normal((FRONT_LN_ROWS * FRONT_LN_STEPS, d),
                             dtype=np.float32)
    ys = rng.integers(0, 2, (len(xs), 1)).astype(np.int32)
    reset_counts(*counters)
    model.fit(xs, ys, epochs=1, verbose=0)
    fit_losses = model.ffmodel.last_epoch_losses
    preds = model.predict(xs[:FRONT_LN_ROWS])
    flash_f, flash_b, ln = (c.launches for c in counters)
    forwards = FRONT_LN_STEPS + 1
    print(f"frontends keras residual block (Dense {BERT['d_ff']} relu, "
          f"Dense {d}, Add, LayerNormalization, Dense 2; {FRONT_LN_ROWS} "
          f"rows, bf16): fit {FRONT_LN_STEPS} steps, losses "
          f"{[round(float(v), 4) for v in fit_losses]}, predict "
          f"{tuple(preds.shape)}; LayerNorm launches {ln} over "
          f"{forwards} forwards, flash {flash_f} + {flash_b} [{card}]")
    assert ln == forwards and flash_f == flash_b == 0, (ln, flash_f,
                                                        flash_b)
    assert preds.shape == (FRONT_LN_ROWS, 2) and np.isfinite(preds).all()
    del model
    free_garbage()
    return {"ln": ln, "err": err}


def frontends_phase(ft, cuda_pool, counters, card: str) -> dict:
    """A.11's frontends on the card: the runner's subprocesses (d)
    started first, then (a)-(c) in this process, then (d) checked.
    Returns each path's launches and the kernels' errors at the new
    shapes."""
    import shutil
    import tempfile

    import torch

    workdir = tempfile.mkdtemp(prefix="ff-front-")
    procs = front_start_runner(workdir)
    try:
        gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
        nn_path = front_nn_path(ft, cuda_pool, card)
        keras_path = front_keras_path(ft, cuda_pool, gen, card)
        ln_path = front_ln_path(ft, counters, card)
        runner = front_finish_runner(procs, workdir, card)
    finally:
        # a failure above leaves no runner process behind
        for proc, out, err, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            out.close()
            err.close()
        shutil.rmtree(workdir, ignore_errors=True)
    return {"nn": nn_path, "keras": keras_path, "ln": ln_path,
            "runner": runner}


# ----------------------------------------------------------------------
# the tooling phase: fit's trace plane, the metrics endpoint, the trace
# and flight verbs, the lock analysis and the benches (A.11)
# ----------------------------------------------------------------------
# (a) BERT-base traced: fit over TOOL_BATCHES batches of BERT_BATCH in
# windows of TOOL_K steps
TOOL_BATCHES = 4
TOOL_K = 2
TOOL_TIMEOUT = 300
# (b) the runner's AlexNet fit with --metrics-port: steps at batch BATCH
TOOL_METRICS_STEPS = 2
# (d) the FF_LOCKWATCH=1 process: AlexNet requests of 1-4 rows, LM
# prompts x new tokens, and the fleet round's requests a tenant
TOOL_LW_SERVE = 48
TOOL_LW_GEN = (8, 16)
TOOL_LW_FLEET = 4
# (e) the benches through the runner's verbs, on the card
TOOL_BENCHES = (
    ("train-bench", ["train-bench", "--ks", "1,4,8,16", "--steps", "64",
                     "--epochs", "2"]),
    ("precision-bench", ["precision-bench"]),
    ("serve-bench", ["serve-bench", "--requests", "256"]),
    ("serve-bench --overload", ["serve-bench", "--overload",
                                "--cell-seconds", "0.5"]),
)
# the profiler names of the hand-written kernels a BERT-base step runs
TOOL_KERNEL_NAMES = ("flash_fwd_tc_kernel", "flash_bwd_dkv_tc_kernel",
                     "flash_bwd_dq_tc_kernel", "layernorm_kernel")

TOOL_METRICS_SCRIPT = """\
import json
import sys
import urllib.request

sys.path.insert(0, {here!r})
import chip_smoke as s
import flexflow_tpu_torch as ft
from flexflow_tpu_torch.obs.registry import validate_prometheus_text
from flexflow_tpu_torch.ops import cuda_pool

cfg = ft.get_default_config()
_, image, classes, _ = s.CNNS["alexnet"]
model, _, _ = s.build_cnn(ft, "alexnet", cfg)
model.compile(ft.SGDOptimizer(lr=0.001), metrics=["accuracy"])
model.init_layers(seed=s.SEED)
xs, y = ft.synthetic_dataset(s.TOOL_METRICS_STEPS * cfg.batch_size,
                             [(3, image, image)], (1,),
                             num_classes=classes, seed=s.SEED)
fwd, bwd = cuda_pool.max_pool_nhwc, cuda_pool.max_pool_nhwc_backward
s.reset_counts(fwd, bwd)
model.fit(xs, y, epochs=1, verbose=False)
launches = (fwd.launches, bwd.launches)
url = f"http://{{cfg.metrics_host}}:{{cfg.metrics_port}}/metrics"
text = urllib.request.urlopen(url, timeout=60).read().decode()
print("TOOL_METRICS " + json.dumps({{
    "batch_size": cfg.batch_size, "compute_dtype": cfg.compute_dtype,
    "device": model.device.type, "steps": model._step,
    "pool_fwd": launches[0], "pool_bwd": launches[1],
    "problems": validate_prometheus_text(text),
    "train": sorted({{ln.split()[0] for ln in text.splitlines()
                     if ln.startswith("ff_train_")}})}}))
"""

TOOL_CRASH_SCRIPT = """\
import torch

torch.ones(4, device="cuda").sum().item()
raise RuntimeError("tooling crash probe")
"""


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def tool_start(workdir: str) -> dict:
    """Start (b), (c) and (d)'s subprocesses, their output to files in
    ``workdir``: the runner with --metrics-port over the AlexNet script,
    the runner over a script that raises with FF_FLIGHT_DIR set, and
    this file's --lockwatch workload under FF_LOCKWATCH=1."""
    for name, text in (("metrics.py", TOOL_METRICS_SCRIPT.format(
            here=HERE)), ("crash.py", TOOL_CRASH_SCRIPT)):
        with open(os.path.join(workdir, name), "w") as f:
            f.write(text)
    cli = [sys.executable, "-m", "flexflow_tpu_torch.cli"]
    port = free_port()
    env = dict(os.environ)
    cmds = {
        "metrics": (cli + [os.path.join(workdir, "metrics.py"), "-b",
                           str(BATCH), "-e", "1", "--compute-dtype",
                           "bfloat16", "--metrics-port", str(port)], env),
        "crash": (cli + [os.path.join(workdir, "crash.py")],
                  dict(env, FF_FLIGHT_DIR=os.path.join(workdir, "flight"))),
        "lockwatch": ([sys.executable, os.path.join(HERE, "chip_smoke.py"),
                       "--lockwatch", os.path.join(workdir, "lw.json")],
                      dict(env, FF_LOCKWATCH="1")),
    }
    procs = {"port": port}
    for name, (cmd, penv) in cmds.items():
        out = open(os.path.join(workdir, f"{name}.out"), "w")
        err = open(os.path.join(workdir, f"{name}.err"), "w")
        procs[name] = (subprocess.Popen(cmd, cwd=HERE, stdout=out,
                                        stderr=err, env=penv), out, err,
                       time.perf_counter())
    return procs


def tool_wait(procs, workdir: str) -> dict:
    """Wait for the subprocesses; returns name -> (exit code, stdout,
    stderr, seconds)."""
    done = {}
    for name, item in procs.items():
        if name == "port":
            continue
        proc, out, err, t0 = item
        rc = proc.wait(timeout=TOOL_TIMEOUT)
        out.close()
        err.close()
        texts = []
        for ext in ("out", "err"):
            with open(os.path.join(workdir, f"{name}.{ext}")) as f:
                texts.append(f.read())
        done[name] = (rc, texts[0], texts[1], time.perf_counter() - t0)
    return done


def tool_cli(argv) -> tuple:
    """(exit code, stdout) of the runner's ``main`` in this process."""
    from flexflow_tpu_torch import cli

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        try:
            cli.main(list(argv))
            rc = 0
        except SystemExit as e:
            rc = 0 if e.code is None else e.code
    return rc, out.getvalue()


def kernel_busy_ms(fn) -> float:
    """The kernels' device time over one call of ``fn`` (torch
    profiler): what the traced file's ``"cat": "kernel"`` events sum to,
    so without the copies, the memsets and the ranges that
    ``record_function`` marks on the device's timeline."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    skip = ("train_window#", "train#", "ProfilerStep", "Memcpy", "Memset")
    total = sum(e.self_device_time_total for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA
                and not e.key.startswith(skip))
    assert total > 0, "the profiler saw no kernel"
    return total / 1e3


def tool_traced_bert(ft, counters, workdir: str, card: str) -> dict:
    """(a): BERT-base's fit in windows of TOOL_K under ``trace_dir`` and
    the span tracer; the profiler's overhead against the same fit
    untraced; the raw spans through ``trace export``."""
    import numpy as np
    import torch

    from flexflow_tpu_torch.fflogger import silenced
    from flexflow_tpu_torch.models import build_transformer
    from flexflow_tpu_torch.obs.trace import (get_tracer,
                                              validate_chrome_trace)

    fwd_k, bwd_k, ln_k = counters
    cfg = ft.FFConfig(batch_size=BERT_BATCH, compute_dtype="bfloat16",
                      seed=SEED)
    cfg.steps_per_dispatch = TOOL_K
    model, _, logits = build_transformer(cfg, **BERT)
    model.compile(ft.AdamOptimizer(alpha=1e-4), final_tensor=logits)
    model.init_layers(seed=SEED)
    assert model.warmup_compile() == ["flash_attention", "fused_layernorm"]
    rng = np.random.default_rng(SEED)
    n = TOOL_BATCHES * BERT_BATCH
    xs = rng.integers(0, BERT["vocab_size"], (n, BERT["seq_len"])).astype(
        np.int32)
    y = rng.integers(0, BERT["num_classes"], (n, 1)).astype(np.int32)

    def fit():
        with silenced("ff"):
            model.fit(xs, y, epochs=1, verbose=False)

    fit()   # warm: the allocator's blocks and cuBLAS's plans
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fit()
    torch.cuda.synchronize()
    wall_plain = (time.perf_counter() - t0) * 1e3
    busy_plain = kernel_busy_ms(fit)

    tracer = get_tracer()
    tracer.disable()
    tracer.reset()
    cfg.trace_dir = os.path.join(workdir, "profile")
    cfg.trace_sample_rate = 1.0
    reset_counts(*counters)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fit()
    torch.cuda.synchronize()
    wall_traced = (time.perf_counter() - t0) * 1e3
    launches = {"fwd": fwd_k.launches, "bwd": bwd_k.launches,
                "ln": ln_k.launches}
    cfg.trace_dir = ""
    cfg.trace_sample_rate = 0.0
    raw = tracer.snapshot()
    raw_path = os.path.join(workdir, "spans.json")
    tracer.save(raw_path)
    tracer.disable()
    tracer.reset()
    path = model.last_trace_file
    assert path and os.path.dirname(path) == os.path.join(workdir,
                                                          "profile"), path
    size = os.path.getsize(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    busy_traced = sum(e.get("dur", 0) for e in kernels) / 1e3
    names = {e["name"] for e in kernels}
    found = {k: sum(1 for e in kernels if k in e["name"])
             for k in TOOL_KERNEL_NAMES}
    assert all(found.values()), (found, sorted(names)[:20])
    ranges = sorted(e["name"] for e in events
                    if e.get("name", "").startswith("train_window#"))
    layers, steps = BERT["num_layers"], TOOL_BATCHES
    assert launches == {"fwd": layers * steps, "bwd": layers * steps,
                        "ln": 2 * layers * steps}, launches
    spans = raw["spans"]
    ids = {s.get("trace") for s in spans}
    assert [s["name"] for s in spans] == ["train_window"] * (
        steps // TOOL_K), spans
    assert len(ids) == 1 and None not in ids, ids
    assert [s["args"]["steps"] for s in spans] == [TOOL_K] * (
        steps // TOOL_K), spans
    chrome_path = os.path.join(workdir, "spans_chrome.json")
    rc, _ = tool_cli(["trace", "export", raw_path, "--out", chrome_path])
    assert rc == 0, rc
    with open(chrome_path) as f:
        chrome = json.load(f)
    assert validate_chrome_trace(chrome) == [] and len(
        chrome["traceEvents"]) == len(spans)
    print(f"tooling traced fit: BERT-base batch {BERT_BATCH} bf16, "
          f"{steps} steps in windows of {TOOL_K}; profiler file "
          f"{os.path.basename(path)} ({size} bytes, {len(events)} events, "
          f"{len(kernels)} kernel events; hand-written kernel events "
          f"{json.dumps(found)}; ranges {ranges}); launches flash "
          f"{launches['fwd']} forward + {launches['bwd']} backward, "
          f"LayerNorm {launches['ln']}; {len(spans)} train_window spans "
          f"under trace {ids.pop()}, steps "
          f"{[s['args']['steps'] for s in spans]}; trace export exit 0, "
          f"{len(chrome['traceEvents'])} Chrome events valid [{card}]")
    over = {"busy_ms_a_step_plain": round(busy_plain / steps, 3),
            "busy_ms_a_step_traced": round(busy_traced / steps, 3),
            "wall_ms_a_step_plain": round(wall_plain / steps, 3),
            "wall_ms_a_step_traced": round(wall_traced / steps, 3),
            "trace_bytes": size}
    print(f"tooling profiler overhead (BERT-base, a step at batch "
          f"{BERT_BATCH}, bf16, fit of {steps} steps; traced wall "
          f"includes the profiler's start, stop and file export): "
          f"{json.dumps(over)} [{card}]")
    del model
    free_garbage()
    return {"launches": launches, "overhead": over}


def tool_check_metrics(done: dict, port: int, card: str) -> dict:
    """(b): the runner's --metrics-port run."""
    rc, out, err, secs = done["metrics"]
    assert rc == 0, (rc, err[-3000:])
    assert f"[obs] metrics on 127.0.0.1:{port}/metrics" in err, err[-2000:]
    line = [ln for ln in out.splitlines() if ln.startswith("TOOL_METRICS ")]
    assert len(line) == 1, out[-3000:]
    rec = json.loads(line[0][len("TOOL_METRICS "):])
    steps = TOOL_METRICS_STEPS
    pools = CNNS["alexnet"][3]
    assert rec["device"] == "cuda" and rec["batch_size"] == BATCH, rec
    assert rec["steps"] == steps and rec["problems"] == [], rec
    assert (rec["pool_fwd"], rec["pool_bwd"]) == (pools * steps,
                                                  pools * steps), rec
    assert rec["train"] == ["ff_train_dispatch_ms",
                            "ff_train_dispatches_total",
                            "ff_train_samples_total",
                            "ff_train_steps_total"], rec
    print(f"tooling metrics: python -m flexflow_tpu_torch.cli metrics.py "
          f"-b {BATCH} --metrics-port {port} exit 0 (done within "
          f"{secs:.1f} s of its start); AlexNet 229 px {rec['compute_dtype']}"
          f" {steps} steps, pool launches {rec['pool_fwd']} forward + "
          f"{rec['pool_bwd']} backward ({pools} + {pools} a step); its own "
          f"scrape valid, {rec['train']} [{card}]")
    return {"fwd": rec["pool_fwd"], "bwd": rec["pool_bwd"]}


def tool_check_flight(done: dict, workdir: str, card: str) -> None:
    """(c): the crashed script's one dump and the flight verbs."""
    from flexflow_tpu_torch.obs.flight import validate_flight_dump

    rc, out, err, secs = done["crash"]
    assert rc != 0 and "tooling crash probe" in err, (rc, err[-2000:])
    fdir = os.path.join(workdir, "flight")
    dumps = sorted(os.listdir(fdir))
    assert len(dumps) == 1 and dumps[0].startswith(
        "flight_fatal_exception_"), dumps
    with open(os.path.join(fdir, dumps[0])) as f:
        dump = json.load(f)
    assert validate_flight_dump(dump) == [], dump
    rc_dump, text = tool_cli(["flight", "dump", "--dir", fdir])
    assert rc_dump == 0 and text.strip() == os.path.join(fdir, dumps[0])
    rc_show, text = tool_cli(["flight", "show", "--dir", fdir])
    assert rc_show == 0 and "reason=fatal_exception" in text, text
    empty = os.path.join(workdir, "empty")
    os.makedirs(empty)
    rc_empty, _ = tool_cli(["flight", "dump", "--dir", empty])
    assert rc_empty == 1
    print(f"tooling flight: the script exit {rc} (within {secs:.1f} s), "
          f"one dump {dumps[0]} valid ({len(dump['records'])} records, "
          f"extra {json.dumps(dump['extra'])[:120]}); flight dump exit "
          f"{rc_dump}, flight show exit {rc_show}, flight dump on an "
          f"empty directory exit {rc_empty} [{card}]")


def tool_check_locks(done: dict, workdir: str, lint: tuple,
                     card: str) -> None:
    """(d): lint --concurrency over the port's tree, and the runtime
    edges of the FF_LOCKWATCH=1 process against the static graph."""
    from flexflow_tpu_torch.obs import lockwatch

    rc, text = lint
    assert rc == 0 and "no diagnostics" in text, text[-3000:]
    prc, out, err, secs = done["lockwatch"]
    assert prc == 0, (prc, err[-3000:])
    with open(os.path.join(workdir, "lw.json")) as f:
        rep = json.load(f)
    runtime = {tuple(e) for e in rep["runtime"]}
    static = {tuple(e) for e in rep["static"]}
    missing = sorted(runtime - static)
    assert rep["cycle"] is None and not missing, (rep["cycle"], missing)
    assert lockwatch.find_cycle(runtime) is None
    assert rep["scrape_problems"] == [], rep["scrape_problems"]
    roster = text.strip().splitlines()[-1]
    print(f"tooling locks: lint --concurrency exit 0 ({roster}); "
          f"FF_LOCKWATCH=1 run (AlexNet "
          f"{TOOL_LW_SERVE} requests, GPT-2-small-width LM "
          f"{TOOL_LW_GEN[0]} x {TOOL_LW_GEN[1]} tokens, a two-tenant fleet "
          f"round and one scrape; within {secs:.1f} s) observed "
          f"{len(runtime)} runtime edges, all among the {len(static)} "
          f"static ones, no cycle; its launches {json.dumps(rep['launches'])}"
          f" [{card}]")


def tool_benches(card: str, kernel_counters) -> dict:
    """(e): the benches through the runner's verbs, in this process, on
    the card; their dense models launch no hand-written kernel."""
    reset_counts(*kernel_counters)
    payloads = {}
    for label, argv in TOOL_BENCHES:
        t0 = time.perf_counter()
        rc, out = tool_cli(argv)
        assert rc == 0, (label, rc, out[-2000:])
        payloads[label] = json.loads(out)
        payloads[label]["_seconds"] = round(time.perf_counter() - t0, 3)
    launches = [k.launches for k in kernel_counters]
    assert launches == [0] * len(kernel_counters), launches
    name = _card_name()
    tb = payloads["train-bench"]
    assert tb["backend"] == "cuda" and tb["device_kind"] == name, tb
    assert [r["dispatches"] for r in tb["results"]] == [
        -(-64 // k) * 2 for k in (1, 4, 8, 16)], tb["results"]
    print("tooling train-bench: " + json.dumps({
        f"K={r['steps_per_dispatch']}": {
            "steps_per_sec": r["steps_per_sec"],
            "ms_per_step": r["ms_per_step"],
            "speedup_vs_k1": r["speedup_vs_k1"],
            "final_loss": r["final_loss"]} for r in tb["results"]})
        + f" ({tb['_seconds']} s) [{card}]")
    pb = payloads["precision-bench"]
    assert pb["backend"] == "cuda" and pb["serve"]["quality"]["bound_ok"]
    print("tooling precision-bench: " + json.dumps({
        "bf16_over_f32": pb["train"]["bf16_over_f32"],
        "f32_steps_per_sec": pb["train"]["float32"]["steps_per_sec"],
        "bf16_steps_per_sec": pb["train"]["bfloat16"]["steps_per_sec"],
        "int8_over_baseline": pb["serve"]["int8_over_baseline"],
        "int8_rows_per_s": pb["serve"]["int8_rows_per_s"],
        "baseline_rows_per_s": pb["serve"]["baseline_rows_per_s"],
        "max_abs_err": pb["serve"]["quality"]["max_abs_err"],
        "search": {k: pb["search"][k] for k in (
            "baseline_all_f32_ms", "mixed_precision_ms", "speedup",
            "mixed_beats_baseline", "bf16_ops", "best_mesh")}})
        + f" ({pb['_seconds']} s) [{card}]")
    sb = payloads["serve-bench"]
    assert sb["backend"] == "cuda" and sb["engine"]["dispatches"] > 0
    print("tooling serve-bench: " + json.dumps({
        "engine_rows_per_s": sb["engine"]["qps_rows"],
        "naive_rows_per_s": sb["naive"]["qps_rows"],
        "speedup_rows": sb["speedup_rows"],
        "engine_p50_ms": sb["engine"]["p50_ms"],
        "engine_p99_ms": sb["engine"]["p99_ms"],
        "paced_p50_ms": sb["paced"]["p50_ms"],
        "paced_p99_ms": sb["paced"]["p99_ms"],
        "paced_rate_rps": sb["paced"]["offered_rate_rps"]})
        + f" ({sb['_seconds']} s) [{card}]")
    ob = payloads["serve-bench --overload"]
    cells = ob["cells"]
    assert len(cells) == 12 and all(c["reconciled"] for c in cells)
    print("tooling serve-bench --overload: " + json.dumps({
        "capacity_rps": ob["capacity"]["qps_requests"],
        "slo_ms": ob["config"]["slo_ms"],
        "goodput_rows_per_s": {f"{c['policy']} x{c['offered_mult']}":
                               c["goodput_rows_per_s"] for c in cells},
        "summary": ob["summary"]}) + f" ({ob['_seconds']} s) [{card}]")
    return {k: v["_seconds"] for k, v in payloads.items()}


def _card_name() -> str:
    import torch
    return torch.cuda.get_device_name(0)


def tooling_phase(ft, counters, kernel_counters, card: str) -> dict:
    """A.11's tooling plane on the card: (b)-(d)'s subprocesses started
    first, lint --concurrency meanwhile, then (a) and (e) in this
    process once they are done (so nothing else loads the host while
    (a) and (e) time), then (b)-(d) checked.  Returns the launches of
    (a) and (b)."""
    import shutil
    import tempfile

    workdir = tempfile.mkdtemp(prefix="ff-tool-")
    procs = tool_start(workdir)
    try:
        lint = tool_cli(["lint", "--concurrency"])
        done = tool_wait(procs, workdir)
        traced = tool_traced_bert(ft, counters, workdir, card)
        metrics = tool_check_metrics(done, procs["port"], card)
        tool_check_flight(done, workdir, card)
        tool_check_locks(done, workdir, lint, card)
        benches = tool_benches(card, kernel_counters)
    finally:
        for name, item in procs.items():
            if name == "port":
                continue
            proc, out, err, _ = item
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            out.close()
            err.close()
        shutil.rmtree(workdir, ignore_errors=True)
    return {"bert": traced["launches"], "alexnet": metrics,
            "overhead": traced["overhead"], "benches": benches}


# the serving benches: the runner's serve-bench modes in this process,
# on the card.  The LMs take GPT-2 small's depth and widths (12 x 768,
# 12 heads) through the benches' flags and keep the benches' own
# 128-token vocabulary and float32 (the generation phase serves the
# 50,257-token head).  To keep the phase near a minute and a half,
# --generate serves 48 requests (96 by default; cut to make room for the
# examples phase) and its SLO sweep offers one load (1x capacity; 0.5x,
# 1x and 2x by default), --speculate serves 8 requests x 32 tokens (16 x
# 64 by default) and the fleet's cells last 0.5 s (2 s by default)
BENCH_GPT2 = ["--d-model", "768", "--heads", "12", "--layers", "12"]
SERVE_BENCHES = (
    ("generate", ["serve-bench", "--generate", *BENCH_GPT2, "--requests",
                  "48", "--mults", "1"]),
    ("prefix", ["serve-bench", "--generate", "--prefix", *BENCH_GPT2]),
    ("speculate", ["serve-bench", "--generate", "--speculate",
                   *BENCH_GPT2, "--draft-layers", "1", "--requests", "8",
                   "--new-tokens", "32"]),
    ("fleet", ["serve-bench", "--fleet", "--cell-seconds", "0.5"]),
    ("disagg", ["serve-bench", "--disagg", "--d-model", "768",
                "--num-heads", "12", "--layers", "12"]),
)
# each payload's logic booleans, asserted (the timing ones are printed)
SERVE_BENCH_CHECKS = {
    "generate": ("parity", ("engine_eq_reference", "schedulers_agree")),
    "prefix": ("acceptance", ("prefix_parity", "hbm_high_water_ok",
                              "reconciliation_ok")),
    "speculate": ("acceptance", ("greedy_parity", "sampled_reproducible")),
    "fleet": ("summary", ("a_queue_bounded", "swap_zero_failed",
                          "swap_reconciled")),
    "disagg": ("acceptance", ("tokens_bit_identical", "reconciliation_ok",
                              "all_migrated")),
}


def bench_headline(name: str, p: dict) -> dict:
    """A bench payload's headline readings: its rates, latencies and
    timing booleans (host-bound on one card: recorded, not asserted)."""
    if name == "generate":
        c, st = p["continuous"], p["static"]
        cells = p["slo_sweep"]["cells"]
        return {"continuous_tokens_per_s": c["tokens_per_s"],
                "static_tokens_per_s": st["tokens_per_s"],
                "speedup_tokens": p["speedup_tokens"],
                "ttft": c["ttft"], "tpot_p50_ms": c["tpot_p50_ms"],
                "tpot_p99_ms": c["tpot_p99_ms"],
                "slot_efficiency": st["slot_efficiency"],
                "slo_ms": p["slo_sweep"]["slo_ms"],
                "goodput_tokens_per_s": {
                    f"{c['policy']} x{c['offered_mult']}":
                    c["goodput_tokens_per_s"] for c in cells}}
    if name == "prefix":
        on, off = p["prefix_cache"]["on"], p["prefix_cache"]["off"]
        ch = p["chunked_prefill"]
        return {"ttft_p95_ms_on": on["ttft"]["p95_ms"],
                "ttft_p95_ms_off": off["ttft"]["p95_ms"],
                "prefix_hit_tokens": on["prefix_hit_tokens"],
                "stall_ms_monolithic": ch["monolithic"]["victim_max_gap_ms"],
                "stall_ms_chunked": ch["chunked"]["victim_max_gap_ms"],
                "throughput_ratio": ch["throughput_ratio"],
                "kv_high_water_bytes": p["kv_memory"],
                **{k: p["acceptance"][k] for k in (
                    "ttft_cache_win", "chunked_stall_win",
                    "throughput_comparable")}}
    if name == "speculate":
        return {"speedup_tokens": p["speedup_tokens"],
                "spec_tokens_win": p["acceptance"]["spec_tokens_win"],
                "greedy": {r["arm"]: {"tokens_per_s": r["tokens_per_s"],
                                      "tpot_p50_ms": r["tpot_p50_ms"],
                                      "accept_rate": r["accept_rate"]}
                           for r in p["arms"]["greedy"]}}
    if name == "fleet":
        return {"capacity_rps": p["capacity_rps"],
                "slo_ms": p["config"]["slo_ms"],
                "b_goodput_ratio": p["summary"]["b_goodput_ratio"],
                "isolation_holds": p["summary"]["isolation_holds"],
                "a_shed": p["contended_a_2x"]["shed"],
                "swap_publish_s": p["swap"]["swap_publish_s"]}
    return {"calibration": p["calibration"],
            "victim_max_gap_ms": {
                **{k: r["victim_max_gap_ms"] for k, r in p["colo"].items()},
                "disagg": p["disagg"]["victim_max_gap_ms"]},
            "wall_flood_ttft_p50_ms": {
                **{k: r["flood_ttft"]["p50_ms"]
                   for k, r in p["wall"]["colo"].items()},
                "disagg": p["wall"]["disagg"]["flood_ttft"]["p50_ms"]},
            "migrated_bytes": p["disagg"]["migrated_bytes"],
            **{k: p["acceptance"][k] for k in (
                "baseline_arm", "tpot_p95_better", "victim_stall_better",
                "goodput_no_worse")}}


def serving_benches_phase(kernel_counters, card: str) -> dict:
    """The serving benches through the runner's verbs, in this process,
    on the card (see SERVE_BENCHES); returns the launches by path."""
    import torch
    from flexflow_tpu_torch.serving.generation.bench import make_gen_trace

    name = _card_name()
    switch = sys.getswitchinterval()
    out = {"ln": {}, "fwd": {}}
    for bench, argv in SERVE_BENCHES:
        free_garbage()
        reset_counts(*kernel_counters)
        t0 = time.perf_counter()
        rc, text = tool_cli(argv)
        secs = round(time.perf_counter() - t0, 3)
        launches = [k.launches for k in kernel_counters]
        assert rc == 0, (bench, rc, text[-2000:])
        p = json.loads(text)
        section, keys = SERVE_BENCH_CHECKS[bench]
        logic = {k: p[section][k] for k in keys}
        print(f"serving benches {bench} ({' '.join(argv)}): "
              + json.dumps(bench_headline(bench, p))
              + f"; logic {json.dumps(logic)}; launches (flash fwd, flash "
              f"bwd, layernorm, pool fwd, pool bwd) {launches} ({secs} s) "
              f"[{card}]")
        assert p["backend"] == "cuda" and p["device_kind"] == name, p
        assert all(logic.values()), (bench, logic)
        # the paged attention is plain torch and the dense tenants run
        # cuBLAS: no backward, no pool, and a flash forward only in the
        # reference decode's predict
        assert launches[1] == launches[3] == launches[4] == 0, launches
        if bench == "fleet":
            assert launches == [0] * len(kernel_counters), launches
            continue
        if bench == "generate":
            # reference_decode: one 12-layer forward a token, min(budget,
            # 8) tokens of the first parity_checks requests; the static
            # arm alone runs a 24-launch walk a prefill and a decode step
            c = p["config"]
            lo, hi = (int(v) for v in c["prompt"].split("-"))
            trace = make_gen_trace(c["requests"], lo, hi, c["short_new"],
                                   c["long_new"], c["long_frac"], c["seed"])
            forwards = sum(min(mn, 8) for _, mn in
                           trace[:p["parity"]["reference_checks"]])
            assert launches[0] == 12 * forwards, (launches, forwards)
            out["fwd"]["serve_bench_generate_reference"] = launches[0]
            st = p["static"]
            assert launches[2] >= 24 * (st["decode_steps"] + st["requests"]
                                        + forwards), (launches, st)
        else:
            assert launches[0] == 0, launches
        # every walk of the target runs all 24 of its LayerNorms (a
        # 1-layer draft 2)
        assert launches[2] > 0 and launches[2] % (
            2 if bench == "speculate" else 24) == 0, launches
        out["ln"][f"serve_bench_{bench}"] = launches[2]
    assert sys.getswitchinterval() == switch, sys.getswitchinterval()
    torch.cuda.empty_cache()
    return out


# ----------------------------------------------------------------------
# the examples phase: the repo's example scripts, unchanged, through the
# runner, whose finder resolves their flexflow_tpu imports to the port
# ----------------------------------------------------------------------
EX_DIR = os.path.join(HERE, "examples")
# (a) in subprocesses, started beside the frontends phase: the scripts
# that read model.forward() with numpy, and what each prints once done
EX_CONSOLE = {"print_layers": ("python/native/print_layers.py", "logits[0]:"),
              "print_input": ("python/native/print_input.py",
                              "logits: shape"),
              "tensor_attach": ("python/native/tensor_attach.py",
                                "tensor_attach OK")}
EX_TIMEOUT = 300
# (b) in this process: the scripts that carry the kernels (each fits 4
# batches of its -b), their flags, and their launches a step (flash fwd,
# flash bwd, layernorm, pool fwd, pool bwd)
EX_KERNEL_SCRIPTS = {
    "examples_alexnet": ("python/native/alexnet.py",
                         ("-b", str(BATCH), "-e", "1"), (0, 0, 0, 3, 3)),
    "examples_transformer": ("apps/transformer.py",
                             ("-b", str(BERT_BATCH), "-e", "1"),
                             (12, 12, 24, 0, 0)),
}


def examples_start(workdir: str) -> dict:
    """Start (a)'s scripts through ``python -m flexflow_tpu_torch.cli``
    with no ``--device`` (the card), each beside a thread that notes
    when it exits; their output goes to files in ``workdir``."""
    cli = [sys.executable, "-m", "flexflow_tpu_torch.cli"]
    procs = {}
    for name, (rel, _) in EX_CONSOLE.items():
        out = open(os.path.join(workdir, f"{name}.out"), "w")
        err = open(os.path.join(workdir, f"{name}.err"), "w")
        t0 = time.perf_counter()
        proc = subprocess.Popen(
            cli + [os.path.join(EX_DIR, rel), "-b", str(BATCH)], cwd=HERE,
            stdout=out, stderr=err)
        done = {}

        def note(proc=proc, done=done):
            proc.wait()
            done["t"] = time.perf_counter()

        threading.Thread(target=note, daemon=True).start()
        procs[name] = (proc, out, err, t0, done)
    return procs


def examples_stop(procs) -> None:
    """Leave no process of :func:`examples_start` behind."""
    for proc, out, err, _, _ in procs.values():
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        out.close()
        err.close()


def examples_cli(rel: str, flags, counters=()) -> tuple:
    """Run ``examples/<rel>`` through the runner's ``main`` in this
    process: (its stdout, its seconds, the ``counters``' launches, its
    ``ff`` events).  The runner installs the default config and device,
    ``sys.argv``, its excepthooks and the import finder; all five are
    put back, so the phases after run as before.  A script that raises
    or exits fails the smoke."""
    from flexflow_tpu_torch import cli, config, script_imports
    from flexflow_tpu_torch.fflogger import capture_events
    from flexflow_tpu_torch.obs import flight

    saved = (config._default_config, config.get_default_device(),
             list(sys.argv), sys.excepthook, threading.excepthook,
             flight._orig_excepthook, flight._orig_thread_hook)
    free_garbage()
    reset_counts(*counters)
    buf = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf), \
                capture_events("ff") as events:
            cli.main([os.path.join(EX_DIR, rel), *flags])
        secs = time.perf_counter() - t0
    except SystemExit as e:
        raise AssertionError(f"examples/{rel} exited {e.code}: "
                             f"{buf.getvalue()[-2000:]}") from e
    finally:
        script_imports.uninstall()
        config.set_default_config(saved[0])
        config.set_default_device(saved[1])
        sys.argv[:] = saved[2]
        sys.excepthook, threading.excepthook = saved[3:5]
        flight._orig_excepthook, flight._orig_thread_hook = saved[5:]
    launches = [k.launches for k in counters]
    assert not any(n == "flexflow_tpu" or n.startswith("flexflow_tpu.")
                   for n in sys.modules), "the finder's names stayed"
    return buf.getvalue(), secs, launches, events


def examples_finish(procs, workdir: str, card: str) -> dict:
    """Wait for (a)'s scripts and check what each printed; returns each
    one's seconds from its start to its exit."""
    walls = {}
    for name, (proc, out, err, t0, done) in procs.items():
        rc = proc.wait(timeout=EX_TIMEOUT)
        out.close()
        err.close()
        with open(os.path.join(workdir, f"{name}.out")) as f:
            text = f.read()
        with open(os.path.join(workdir, f"{name}.err")) as f:
            errtext = f.read()
        assert rc == 0, (name, rc, errtext[-3000:])
        marker = EX_CONSOLE[name][1]
        assert marker in text, (name, text[-2000:])
        while "t" not in done:
            time.sleep(0.01)
        walls[name] = done["t"] - t0
        shown = [ln for ln in text.splitlines() if ln.startswith(marker)]
        print(f"examples {name}: python -m flexflow_tpu_torch.cli "
              f"examples/{EX_CONSOLE[name][0]} -b {BATCH} (the card) exit "
              f"0 in {walls[name]:.3f} s from its start; {shown[0][:120]}"
              f" [{card}]")
    return walls


def examples_phase(procs, workdir: str, kernel_counters,
                   card: str) -> dict:
    """The repo's example scripts on the card through the runner, as a
    user runs them: (a) print_layers.py, print_input.py and
    tensor_attach.py in subprocesses (started before the frontends
    phase; each reads ``np.asarray(model.forward())`` of a model on the
    card), checked here, then run again in this process, warm, through
    the runner's ``main``: a subprocess's seconds less the warm run's
    are its start-up (torch's import and the card's context, beside the
    phases it ran with); (b) alexnet.py (full-width AlexNet, 229 px,
    batch 64) and apps/transformer.py (BERT-base, 12 x 768, s 512, batch
    16, Adam 1e-4) through the runner's ``main`` in this process, each
    fitting 4 batches: the max-pool kernels launch 3 + 3 times an
    AlexNet step, flash attention 12 + 12 and LayerNorm 24 times a
    BERT-base step.  The kernel phases above hold each kernel against
    its plain version at these shapes (AlexNet's pools at batch 64;
    flash and LayerNorm at BERT-base's (16, 512, 12, 64) and 8192 rows),
    so this phase does not repeat them.  Returns each path's launches
    (in ``kernel_counters``' order)."""
    import torch

    walls = examples_finish(procs, workdir, card)
    for name, (rel, marker) in EX_CONSOLE.items():
        text, secs, _, _ = examples_cli(rel, ("-b", str(BATCH)))
        assert marker in text, (name, text[-2000:])
        print(f"examples {name} in this process: {secs:.3f} s warm; its "
              f"subprocess's start-up {walls[name] - secs:.3f} s "
              f"[{card}]")
    out = {}
    for path, (rel, flags, per_step) in EX_KERNEL_SCRIPTS.items():
        text, secs, launches, events = examples_cli(rel, flags,
                                                    kernel_counters)
        epochs = [e for e in events if e.get("event") == "epoch"]
        assert len(epochs) == 1 and "THROUGHPUT" in text, text[-2000:]
        steps = epochs[0]["step"]
        assert steps == 4 and epochs[0]["samples"] == 4 * int(flags[1]), \
            epochs
        assert launches == [steps * n for n in per_step], (path, launches)
        assert math.isfinite(epochs[0]["dispatch_ms"]), epochs
        print(f"examples {path}: flexflow_tpu_torch.cli.main "
              f"examples/{rel} {' '.join(flags)}: exit 0 in {secs:.3f} s, "
              f"{steps} steps, {epochs[0]['dispatch_ms']} ms a dispatch; "
              f"launches (flash fwd, flash bwd, layernorm, pool fwd, pool "
              f"bwd) {launches} ({list(per_step)} a step); "
              + next(ln for ln in text.splitlines() if "THROUGHPUT" in ln)
              + f" [{card}]")
        out[path] = launches
    torch.cuda.empty_cache()
    return out


# ----------------------------------------------------------------------
# the C API over the port (flexflow_tpu_torch/capi/): capi/'s C programs,
# unchanged, against a library that embeds the port
# ----------------------------------------------------------------------
CAPI_DIR = os.path.join(HERE, "capi")
# the programs: their source under capi/, their arguments and the lines
# a run prints once done
CAPI_PROGRAMS = {
    "test_capi": ("test_capi.c", (),
                  ("MLP OK", "transformer OK", "lstm OK", "C API OK")),
    "alexnet": ("examples/alexnet.c", ("-b", str(BATCH), "-e", "1"),
                ("THROUGHPUT",)),
}
# (b) runs test_capi.c's twin, whose checkpoint and strategy file are
# relative paths, in the phase's own directory: capi/test_capi.c writes
# fixed paths under /tmp
CAPI_IN_PROCESS = {"test_capi": os.path.join(HERE, "flexflow_tpu_torch",
                                             "capi", "test_capi.c")}
CAPI_TIMEOUT = 300
# each program's launches in this process (flash fwd, flash bwd,
# layernorm, pool fwd, pool bwd), counted from its graph: alexnet.c
# trains 1 warm-up and 4 steps (-e 1) of 3 max pools; test_capi.c's
# transformer block 12 Adam steps of one causal attention and two
# LayerNorms (its MLP and LSTM launch no kernel of the port's)
CAPI_LAUNCHES = {"test_capi": (12, 12, 24, 0, 0),
                 "alexnet": (0, 0, 0, 15, 15)}
# the shapes these give the kernels: alexnet.c's 64 px input makes
# pools over 15x15x64, 7x7x192 and 3x3x256 (3x3, stride 2); test_capi.c's
# block (8 x 8 tokens, d 16) attention over 2 heads of 8 and LayerNorm
# over (8, 8, 16)
CAPI_ALEXNET_POOLS = [((64, 15, 15), POOL_GEOM), ((192, 7, 7), POOL_GEOM),
                      ((256, 3, 3), POOL_GEOM)]
CAPI_TEST_ATTENTION = (8, 8, 2, 8)
CAPI_TEST_LN = (8, 8, 16)
# (c): test_capi.c's block at BERT-base's widths (its 4 classes), bf16
# steps with Adam, then one float32 step against the Python API's
CAPI_BERT = dict(batch=BERT_BATCH, seq=BERT["seq_len"], d=BERT["d_model"],
                 heads=BERT["num_heads"], ffn=BERT["d_ff"],
                 vocab=BERT["vocab_size"], classes=4)
CAPI_BERT_STEPS = 4
CAPI_BERT_ALPHA = 1e-4
CAPI_F32_TOL = 1e-5


def capi_start(workdir: str) -> dict:
    """In a thread beside the phases that follow: build the port's C
    library and capi/'s programs against it, as shared objects for (b)
    and, where this Python can be embedded, as executables, and start
    (a)'s hosts on the card (FLEXFLOW_PLATFORM dropped from their
    environment), their output in files in ``workdir``."""
    from flexflow_tpu_torch.capi import build

    state = {"procs": {}, "builds": {}, "shared": {}}

    def note(proc, done):
        proc.wait()
        done["t"] = time.perf_counter()

    def run():
        try:
            t0 = time.perf_counter()
            state["library"] = build.build_library()
            state["builds"]["library"] = time.perf_counter() - t0
            for name, (src, _, _) in CAPI_PROGRAMS.items():
                t0 = time.perf_counter()
                state["shared"][name] = build.build_host(
                    CAPI_IN_PROCESS.get(name, os.path.join(CAPI_DIR, src)),
                    name, shared=True)
                state["builds"][f"{name}.so"] = time.perf_counter() - t0
            try:
                build.python_link()
            except RuntimeError as e:
                state["no_host"] = str(e)
                return
            env = build.host_env()
            env.pop("FLEXFLOW_PLATFORM", None)
            for name, (src, args, _) in CAPI_PROGRAMS.items():
                t0 = time.perf_counter()
                exe = build.build_host(os.path.join(CAPI_DIR, src), name)
                state["builds"][name] = time.perf_counter() - t0
                out = open(os.path.join(workdir, f"{name}.out"), "w")
                err = open(os.path.join(workdir, f"{name}.err"), "w")
                t0 = time.perf_counter()
                proc = subprocess.Popen([exe, *args], cwd=workdir, env=env,
                                        stdout=out, stderr=err)
                done = {}
                threading.Thread(target=note, args=(proc, done),
                                 daemon=True).start()
                state["procs"][name] = (proc, out, err, t0, done)
        except BaseException as e:  # noqa: BLE001 — raised by the phase
            state["error"] = e

    state["thread"] = threading.Thread(target=run, daemon=True)
    state["thread"].start()
    return state


def capi_stop(state) -> None:
    """Leave no process of :func:`capi_start` behind."""
    state["thread"].join()
    for proc, out, err, _, _ in state["procs"].values():
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        out.close()
        err.close()


def capi_finish(state, workdir: str, card: str) -> dict:
    """The build's probe and times, then (a): wait for each host and
    check what it printed; returns each one's (seconds from its start to
    its exit, its stdout)."""
    import sysconfig

    state["thread"].join(CAPI_TIMEOUT)
    assert not state["thread"].is_alive(), "capi build still running"
    if "error" in state:
        raise state["error"]
    inc = sysconfig.get_config_var("INCLUDEPY")
    gxx = subprocess.run(["g++", "--version"], capture_output=True,
                         text=True).stdout.splitlines()[0]
    print(f"capi probe: INCLUDEPY {inc} (Python.h "
          f"{os.path.exists(os.path.join(inc, 'Python.h'))}), LIBDIR "
          f"{sysconfig.get_config_var('LIBDIR')}, LDLIBRARY "
          f"{sysconfig.get_config_var('LDLIBRARY')}, Py_ENABLE_SHARED "
          f"{sysconfig.get_config_var('Py_ENABLE_SHARED')}; {gxx}")
    print(f"capi build: {os.path.relpath(state['library'], HERE)}; "
          + ", ".join(f"{k} {v:.3f} s" for k, v in state["builds"].items())
          + f" (beside the frontends phase) [{card}]")
    if "no_host" in state:
        print(f"capi (a): no C host on this machine: {state['no_host']}")
        return {}
    hosts = {}
    for name, (proc, out, err, t0, done) in state["procs"].items():
        rc = proc.wait(timeout=CAPI_TIMEOUT)
        out.close()
        err.close()
        with open(os.path.join(workdir, f"{name}.out")) as f:
            text = f.read()
        with open(os.path.join(workdir, f"{name}.err")) as f:
            errtext = f.read()
        assert rc == 0, (name, rc, text[-2000:], errtext[-3000:])
        markers = CAPI_PROGRAMS[name][2]
        assert all(m in text for m in markers), (name, text[-2000:])
        capi_final_loss(text)
        while "t" not in done:
            time.sleep(0.01)
        hosts[name] = (done["t"] - t0, text)
        print(f"capi (a) host {name} ({capi_command(name)}, the card): "
              f"exit 0 in "
              f"{hosts[name][0]:.3f} s from its start; "
              + "; ".join(ln for ln in text.splitlines()
                          if any(m in ln for m in markers)
                          or ln.startswith("final loss"))
              + f" [{card}]")
    return hosts


def capi_command(name: str, in_process: bool = False) -> str:
    src, args, _ = CAPI_PROGRAMS[name]
    path = f"capi/{src}"
    if in_process and name in CAPI_IN_PROCESS:
        path = os.path.relpath(CAPI_IN_PROCESS[name], HERE)
    return " ".join((path,) + args)


def capi_final_loss(text: str) -> None:
    """alexnet.c's ``final loss`` line, where a program prints one, must
    read a finite loss."""
    for ln in text.splitlines():
        if ln.startswith("final loss"):
            assert math.isfinite(float(ln.split()[-1])), ln


def capi_main(path: str, argv, cwd: str) -> tuple:
    """Call ``main(argc, argv)`` of the shared object ``path`` in this
    process (``ctypes.PyDLL``: the C layer runs on this interpreter, and
    a Python exception it leaves set raises here), in the directory
    ``cwd``.  Its stdout goes to a file while it runs and C's buffers are
    flushed before fd 1 comes back, so no C line lands after this
    process's own.  Returns (exit code, its stdout, seconds)."""
    import ctypes
    import tempfile

    lib = ctypes.PyDLL(path)
    lib.main.restype = ctypes.c_int
    lib.main.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_char_p)]
    args = (ctypes.c_char_p * len(argv))(*(a.encode() for a in argv))
    libc = ctypes.CDLL(None)
    sys.stdout.flush()
    saved = os.dup(1)
    here = os.getcwd()
    with tempfile.TemporaryFile() as f:
        os.dup2(f.fileno(), 1)
        os.chdir(cwd)
        t0 = time.perf_counter()
        try:
            rc = lib.main(len(argv), args)
        finally:
            libc.fflush(None)
            secs = time.perf_counter() - t0
            os.chdir(here)
            os.dup2(saved, 1)
            os.close(saved)
        f.seek(0)
        text = f.read().decode()
    return rc, text, secs


def capi_py_block(ft, dtype: str):
    """(c)'s block through the port's Python API: the calls the C layer
    makes for abi.transformer_block, then compile and init."""
    b = CAPI_BERT
    m = ft.FFModel(ft.FFConfig.parse_args(["-b", str(b["batch"]),
                                           "--compute-dtype", dtype]))
    tok = m.create_tensor((b["batch"], b["seq"]), "int32", "tokens")
    emb = m.embedding(tok, b["vocab"], b["d"], aggr="none",
                      name="tok_embed")
    pos = m.position_embedding(emb, name="pos_embed")
    attn = m.multihead_attention(pos, embed_dim=b["d"],
                                 num_heads=b["heads"], dropout=0.0,
                                 bias=True, causal=True, name="attn")
    ln1 = m.layer_norm(m.add(pos, attn, name="res1"), name="ln1")
    up = m.dense(ln1, b["ffn"], activation="gelu", use_bias=True,
                 name="ffn_up")
    dn = m.dense(up, b["d"], use_bias=True, name="ffn_down")
    ln2 = m.layer_norm(m.add(ln1, dn, name="res2"), name="ln2")
    fl = m.reshape(ln2, (b["batch"], b["seq"] * b["d"]), name="fl")
    out = m.dense(fl, b["classes"], use_bias=True, name="cls")
    m.compile(ft.AdamOptimizer(alpha=CAPI_BERT_ALPHA, beta1=0.9,
                               beta2=0.999, weight_decay=0.0, epsilon=1e-8),
              "sparse_categorical_crossentropy", final_tensor=out)
    m.init_layers(SEED)
    return m


def capi_bert_block(ft, counters, card: str) -> dict:
    """(c): test_capi.c's transformer block at BERT-base's widths
    through the C functions (ctypes, abi.transformer_block): the bf16
    steps' ms and launches (one flash forward and backward and two
    LayerNorms a step), then one float32 step against the same graph
    through the Python API from the same weights (carried by
    flexflow_model_set_weights)."""
    import ctypes

    import numpy as np
    import torch
    from flexflow_tpu_torch.capi import abi

    lib = abi.load()
    assert lib.flexflow_init() == 0, abi.last_error(lib)
    b = CAPI_BERT
    rng = np.random.default_rng(SEED)
    tok = rng.integers(0, b["vocab"], (b["batch"], b["seq"])).astype(
        np.int32)
    y = rng.integers(0, b["classes"], b["batch"]).astype(np.int32)

    def block(dtype):
        cfg = abi.config(lib, "-b", str(b["batch"]), "--compute-dtype",
                         dtype)
        m, logits = abi.transformer_block(
            lib, cfg, b["batch"], b["seq"], b["d"], b["heads"], b["ffn"],
            b["vocab"], b["classes"])
        opt = abi.check(lib, lib.flexflow_adam_optimizer_create(
            CAPI_BERT_ALPHA, 0.9, 0.999, 0.0, 1e-8), "adam")
        assert lib.flexflow_model_compile_opt(
            m, opt, abi.FF_LOSS_SPARSE_CCE, logits) == 0, abi.last_error(lib)
        assert lib.flexflow_model_init_layers(m, SEED) == 0, \
            abi.last_error(lib)
        return m, (logits, opt, cfg)

    def release(m, handles):
        logits, opt, cfg = handles
        lib.flexflow_tensor_destroy(logits)
        lib.flexflow_optimizer_destroy(opt)
        lib.flexflow_model_destroy(m)
        lib.flexflow_config_destroy(cfg)
        free_garbage()
        torch.cuda.empty_cache()

    def step(m):
        # the C layer reads the loss with PyFloat_AsDouble: a sync
        loss = lib.flexflow_model_train_batch(m, 1, abi.batch(tok),
                                              y.ctypes.data)
        assert math.isfinite(loss), abi.last_error(lib)
        return loss

    free_garbage()
    m, handles = block("bfloat16")
    reset_counts(*counters)
    ms, losses = [], []
    for _ in range(CAPI_BERT_STEPS):
        t0 = time.perf_counter()
        losses.append(step(m))
        ms.append(round((time.perf_counter() - t0) * 1e3, 3))
    launches = [c.launches for c in counters]
    want = [CAPI_BERT_STEPS, CAPI_BERT_STEPS, 2 * CAPI_BERT_STEPS]
    assert launches == want, (launches, want)
    release(m, handles)
    print(f"capi (c) test_capi.c's block at BERT-base's widths through the "
          f"C ABI (batch {b['batch']}, s {b['seq']}, d {b['d']}, "
          f"{b['heads']} heads, causal, FFN {b['ffn']} gelu, vocab "
          f"{b['vocab']}, bf16, Adam {CAPI_BERT_ALPHA}): "
          f"{CAPI_BERT_STEPS} steps, ms a step {ms} (each ends in the "
          f"loss's read), mean of steps 2-{CAPI_BERT_STEPS} "
          f"{sum(ms[1:]) / (len(ms) - 1):.3f} ms; losses "
          f"{[round(v, 4) for v in losses]}; launches (flash fwd, flash "
          f"bwd, layernorm) {launches} [{card}]")

    m, handles = block("float32")
    pm = capi_py_block(ft, "float32")
    for p in pm.parameters:
        w = np.ascontiguousarray(pm.get_weights(p.name), np.float32).ravel()
        assert lib.flexflow_model_set_weights(
            m, p.name.encode(), w.ctypes.data_as(
                ctypes.POINTER(ctypes.c_float)), w.size) == 0, \
            abi.last_error(lib)
    got = step(m)
    want_loss = float(pm.train_batch(tok, y))
    print(f"capi (c) float32 step through the C ABI: loss {got!r} against "
          f"the Python API's {want_loss!r} from the same weights "
          f"({len(pm.parameters)} parameters), |diff| "
          f"{abs(got - want_loss):.3g} (tol {CAPI_F32_TOL}) [{card}]")
    assert abs(got - want_loss) <= CAPI_F32_TOL * max(1.0, abs(want_loss))
    del pm
    release(m, handles)
    return {"launches": launches, "ms": ms}


def capi_phase(ft, state, workdir: str, kernel_counters,
               card: str) -> dict:
    """The C API over the port on the card: (a) capi/test_capi.c and
    capi/examples/alexnet.c (-b 64 -e 1), unchanged, as C hosts linked
    with the port's library and libpython (started before the frontends
    phase), checked here; the kernels held against their plain versions
    at the shapes these programs give them (alexnet.c's three pools,
    test_capi.c's block's LayerNorm; its attention in the flash phase);
    (b) both programs again in this process (built as shared objects,
    test_capi.c as its twin CAPI_IN_PROCESS, ``main`` called through
    ctypes in ``workdir``), their launches counted:
    CAPI_LAUNCHES; a host's seconds less this run's are its start-up;
    (c) capi_bert_block.  Returns each path's launches (in
    ``kernel_counters``' order) and the errors of the kernel checks."""
    import torch
    from flexflow_tpu_torch.ops import cuda_norm, cuda_pool

    hosts = capi_finish(state, workdir, card)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    err_f, err_b = pool_checks(cuda_pool, gen, CAPI_ALEXNET_POOLS,
                               "capi alexnet.c")
    d = CAPI_TEST_LN[-1]
    x = torch.randn(CAPI_TEST_LN, generator=gen, device="cuda").to(
        torch.bfloat16)
    scale = 1 + 0.1 * torch.randn(d, generator=gen, device="cuda")
    bias = 0.1 * torch.randn(d, generator=gen, device="cuda")
    err_ln = ln_check(cuda_norm, x, None, scale, bias,
                      " (test_capi.c's block)")
    out = {"err_fwd": err_f, "err_bwd": err_b, "err_ln": err_ln}
    for name, (src, args, markers) in CAPI_PROGRAMS.items():
        free_garbage()
        reset_counts(*kernel_counters)
        rc, text, secs = capi_main(state["shared"][name], [name, *args],
                                   workdir)
        launches = [k.launches for k in kernel_counters]
        assert rc == 0, (name, rc, text[-2000:])
        assert all(m in text for m in markers), (name, text[-2000:])
        assert launches == list(CAPI_LAUNCHES[name]), (name, launches)
        capi_final_loss(text)
        shown = [ln for ln in text.splitlines()
                 if any(m in ln for m in markers)
                 or ln.startswith("final loss")]
        start = (f"; its host's start-up {hosts[name][0] - secs:.3f} s"
                 if name in hosts else "")
        print(f"capi (b) {name} in this process "
              f"({capi_command(name, in_process=True)}, "
              f"main through ctypes): exit 0 in "
              f"{secs:.3f} s{start}; launches (flash fwd, flash bwd, "
              f"layernorm, pool fwd, pool bwd) {launches}; "
              + "; ".join(shown) + f" [{card}]")
        out[name] = launches
    out["bert"] = capi_bert_block(ft, kernel_counters[:3], card)
    torch.cuda.empty_cache()
    return out


def lockwatch_main(argv) -> int:
    """The FF_LOCKWATCH=1 workload of the tooling phase (d), in a process
    of its own (enablement is sampled when a lock is made, at import):
    AlexNet behind a ServingEngine, the GPT-2-small-width LM behind a
    GenerationEngine, a two-tenant FleetEngine round of both and one
    scrape of the metrics server; writes the runtime and static lock
    edges to ``argv[0]``."""
    import urllib.request

    import numpy as np
    import torch

    sys.path.insert(0, HERE)
    import flexflow_tpu_torch as ft
    from flexflow_tpu_torch.analysis import concurrency as cz
    from flexflow_tpu_torch.fflogger import silenced
    from flexflow_tpu_torch.obs import lockwatch
    from flexflow_tpu_torch.obs.registry import (start_metrics_server,
                                                 validate_prometheus_text)
    from flexflow_tpu_torch.ops import cuda_attention, cuda_norm, cuda_pool
    from flexflow_tpu_torch.serving.fleet import FleetEngine

    assert lockwatch.enabled(), "run with FF_LOCKWATCH=1"
    torch.backends.cuda.matmul.allow_tf32 = False
    counted = (cuda_pool.max_pool_nhwc, cuda_attention.flash_attention_forward,
               cuda_norm.fused_layernorm)
    reset_counts(*counted)
    rng = np.random.default_rng(SEED)
    _, image, classes, _ = CNNS["alexnet"]
    cfg = ft.FFConfig(batch_size=BATCH, compute_dtype="bfloat16", seed=SEED)
    alex, _, _ = build_cnn(ft, "alexnet", cfg)
    alex.compile()
    alex.init_layers(seed=SEED)
    lm = spec_model(ft, GPT2, "bfloat16", SEED)
    n_prompts, n_new = TOOL_LW_GEN
    prompts = [rng.integers(0, GPT2["vocab_size"], 32).astype(np.int32)
               for _ in range(n_prompts)]

    def rows(n):
        return rng.standard_normal((n, 3, image, image)).astype(np.float32)

    gen_kw = {"slots": n_prompts, "page_size": GEN_PAGE,
              "prefill_chunk": GEN_CHUNK}
    with silenced("serve", "obs"):
        with ft.ServingEngine(alex, stats_every=8) as eng:
            futs = [eng.submit(rows(int(n)))
                    for n in rng.integers(1, 5, TOOL_LW_SERVE)]
            for f in futs:
                assert np.isfinite(f.result(timeout=TOOL_TIMEOUT)).all()
        with ft.GenerationEngine(lm, max_new_tokens=n_new, **gen_kw) as gen:
            futs = [gen.submit(p) for p in prompts]
            for f in futs:
                assert 0 < len(f.result(timeout=TOOL_TIMEOUT)) <= n_new
        server = start_metrics_server(0)
        try:
            fleet = FleetEngine()
            fleet.add_engine("alexnet", ft.ServingEngine(alex,
                                                         name="alexnet"))
            fleet.add_engine("lm", ft.GenerationEngine(
                lm, name="lm", **gen_kw))
            with fleet:
                futs = [fleet.submit("alexnet", rows(2))
                        for _ in range(TOOL_LW_FLEET)]
                streams = [fleet.submit("lm", p, max_new_tokens=4)
                           for p in prompts[:TOOL_LW_FLEET]]
                for f in futs + streams:
                    f.result(timeout=TOOL_TIMEOUT)
                text = urllib.request.urlopen(
                    f"http://127.0.0.1:{server.server_port}/metrics",
                    timeout=60).read().decode()
        finally:
            server.shutdown()
            server.server_close()
    an = cz.build()
    with open(argv[0], "w") as f:
        json.dump({"runtime": sorted(lockwatch.edges()),
                   "static": sorted(an.edges),
                   "cycle": lockwatch.report()["cycle"],
                   "scrape_problems": validate_prometheus_text(text),
                   "launches": {"pool_fwd": counted[0].launches,
                                "flash_fwd": counted[1].launches,
                                "layernorm": counted[2].launches}}, f)
    return 0


def build_all(kernels) -> None:
    """One nvcc per source, all started together."""
    from concurrent.futures import ThreadPoolExecutor

    names = ("max_pool_nhwc", "flash_attention", "fused_layernorm")
    with ThreadPoolExecutor(len(names)) as pool:
        builds = list(pool.map(kernels.build, names))
    spills = []
    for name, (path, secs, log) in zip(names, builds):
        # a library built before prints the ptxas output of its build
        print(f"built {os.path.relpath(path, HERE)} in {secs:.2f}s"
              if secs else f"{os.path.relpath(path, HERE)} built before")
        entry = ""
        for line in log.splitlines():
            if "Compiling entry function" in line:
                entry = line.split(chr(39))[1]
                print(f"  ptxas: {entry}")
            elif ("registers" in line or "spill" in line
                  or "warning" in line.lower()):
                print(f"  ptxas: {line.strip()}")
                # the pool kernels are memory-bound: a spill would add
                # local-memory traffic to every thread
                if name == "max_pool_nhwc" and "spill" in line and \
                        " 0 bytes spill stores, 0 bytes spill loads" \
                        not in line:
                    spills.append(f"{entry}: {line.strip()}")
    assert not spills, "max-pool kernels spill:\n" + "\n".join(spills)


def main() -> int:
    if not os.path.isdir(os.path.join(HERE, "flexflow_tpu_torch")):
        print("chip_smoke: flexflow_tpu_torch/ is not beside this script",
              file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import flexflow_tpu_torch as ft
    from flexflow_tpu_torch import kernels
    from flexflow_tpu_torch.ops import cuda_attention, cuda_norm, cuda_pool

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # the engines' event lines (serve_stats, gen_stats, ...) stay off
    # stdout: the phases read what they check through capture_events
    # and the engines' stats(), and print their own lines
    from flexflow_tpu_torch.fflogger import silenced
    stack = contextlib.ExitStack()
    stack.enter_context(silenced("serve", "obs"))
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}")
    card = card_line()
    print(card)
    seconds = {}

    def phase(label, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[label] = round(time.perf_counter() - t0, 3)
        print(f"phase {label}: {seconds[label]}s")
        return out

    counters = (cuda_attention.flash_attention_forward,
                cuda_attention.flash_attention_backward,
                cuda_norm.fused_layernorm)
    kernel_counters = counters + (cuda_pool.max_pool_nhwc,
                                  cuda_pool.max_pool_nhwc_backward)

    build_all(kernels)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    kp = phase("pool forward kernel", kernel_phase, cuda_pool, gen)
    bp = phase("pool backward kernel", backward_kernel_phase, cuda_pool, gen)
    fp = phase("flash kernels", flash_phase, cuda_attention, gen, card)
    lp = phase("layernorm kernel", layernorm_phase, cuda_norm, gen)
    phase("layernorm plan sweep", ln_plan_sweep, cuda_norm, gen, card)
    phase("avg pool forms", avg_pool_phase, gen, card)
    serve, train = {}, {}
    for name in CNNS:
        serve[name] = phase(f"{name} serve", serve_phase, ft, cuda_pool,
                            card, name)
        train[name] = phase(f"{name} train", train_phase, ft, cuda_pool,
                            card, name)
    phase("resnet50 batch_norm", batchnorm_phase, ft, cuda_pool, card)
    phase("cnn f32 steps", cnn_f32_step_checks, ft, cuda_pool)
    tserve = phase("transformer serve", transformer_serve_phase, ft,
                   counters, card)
    ttrain = phase("transformer train", transformer_train_phase, ft,
                   counters, card)
    phase("transformer f32 step", transformer_f32_step_check, ft, counters)
    tgen = phase("generation", generation_phase, ft, counters, card)
    tquant = phase("bert int8 serve", bert_quantized_phase, ft, counters,
                   card)
    tspec = phase("speculative generation", spec_generation_phase, ft,
                  counters, card)
    bremat = phase("bert remat", bert_remat_phase, ft, counters, card)
    baccum = phase("bert accumulate", bert_accumulate_phase, ft, counters,
                   card)
    rknobs = phase("resnet50 knobs", resnet50_knobs_phase, ft, cuda_pool,
                   card)
    ckpt = phase("checkpoint", checkpoint_phase, ft, cuda_pool, card)
    phase("moe", moe_phase, ft, card)
    tpipe = phase("pipeline", pipeline_phase, ft, cuda_norm, counters, card)
    for name in ZOO:
        phase(name, zoo_phase, ft, name, card, kernel_counters)
    phase("zoo f32 steps", zoo_f32_step_checks, ft)
    phase("dlrm hetero", dlrm_hetero_phase, ft, card, kernel_counters)
    bpin = phase("bert pinned", bert_precision_phase, ft, counters, card)
    phase("verifier", verifier_phase, ft, card)
    tsearch = phase("search", search_phase, ft, card)
    tcalib = phase("calibration", calibration_phase, ft, card)
    # the examples phase's console scripts start up beside the
    # frontends phase (and its own runner subprocesses); the examples
    # phase below checks them
    import atexit
    import shutil
    import tempfile
    ex_dir = tempfile.mkdtemp(prefix="ff-examples-")
    ex_procs = examples_start(ex_dir)
    # a failure in any phase before the examples phase leaves no
    # process behind (atexit runs last-in first-out)
    atexit.register(shutil.rmtree, ex_dir, ignore_errors=True)
    atexit.register(examples_stop, ex_procs)
    # the capi phase's build and C hosts, likewise
    capi_dir = tempfile.mkdtemp(prefix="ff-capi-")
    capi_state = capi_start(capi_dir)
    atexit.register(shutil.rmtree, capi_dir, ignore_errors=True)
    atexit.register(capi_stop, capi_state)
    tfront = phase("frontends", frontends_phase, ft, cuda_pool, counters,
                   card)
    # last: each engine thread that ran a matmul leaves its cuBLAS
    # workspace (32 MiB a concurrently used handle) allocated, which no
    # training step's peak above may count
    tmesh = phase("mesh", mesh_phase, ft, card)
    tdis = phase("disaggregated serving", disagg_phase, ft, counters, card)
    tfleet = phase("fleet", fleet_phase, ft, counters, card)
    phase("elastic", elastic_phase, card)
    ttool = phase("tooling", tooling_phase, ft, counters, kernel_counters,
                  card)
    tbench = phase("serving benches", serving_benches_phase,
                   kernel_counters, card)
    tex = phase("examples", examples_phase, ex_procs, ex_dir,
                kernel_counters, card)
    tcapi = phase("capi", capi_phase, ft, capi_state, capi_dir,
                  kernel_counters, card)
    worst = max(MEMORY, key=lambda r: r["ratio"])
    print(f"memory factor: largest ratio {worst['ratio']:.4f} "
          f"({worst['step']}) over {len(MEMORY)} training steps [{card}]")
    print("memory ratios: " + json.dumps(MEMORY))
    print("phase seconds: " + json.dumps(seconds))

    def sums(rows):
        return {"ms": sum(r["kernel_ms"] for r in rows),
                "plain_ms": sum(r["plain_ms"] for r in rows),
                "bound_ms": sum(r["bound_ms"] for r in rows),
                "library_ms": sum(r["library_ms"] for r in rows)}

    def entry(name, replaces, by_path, phase):
        shapes = phase["shapes"]
        return {
            "name": name,
            "route": "cuda",
            "source": "flexflow_tpu_torch/csrc/max_pool_nhwc.cu",
            "replaces": replaces,
            "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": phase["max_abs_err"],
            # the max pools of one forward (or one backward) of each of
            # AlexNet, ResNet-50 and InceptionV3 at batch 64, bf16; each
            # model's own sums beside them
            **sums(shapes),
            "bound_by": max(shapes,
                            key=lambda r: r["bound_ms"])["bound_by"],
            "by_model": {m: sums([r for r in shapes if r["model"] == m])
                         for m in MODEL_POOLS},
            "design": shapes[0]["design"],
            # the timing rows without the launch's vector and tile, then
            # the large windows (on no model's path)
            "shapes": [{key: v for key, v in r.items()
                        if key not in ("vec", "tile")} for r in shapes],
            "large_windows": [{key: v for key, v in r.items()
                               if key != "vec"} for r in phase["large"]],
        }

    def call_entry(name, source, replaces, by_path, phase):
        # one call at BERT-base's shapes (batch 16, bf16)
        t = phase["timing"]
        extra = {"design": t["design"]} if "design" in t else {}
        if "sweep_max_abs_err" in phase:
            extra["sweep_max_abs_err"] = phase["sweep_max_abs_err"]
        extra.update(phase.get("headline_extra", {}))
        return {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": phase["max_abs_err"], "ms": t["kernel_ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            **extra, "shapes": phase.get("shapes", [t]),
        }

    flash_src = "flexflow_tpu_torch/csrc/flash_attention.cu"
    # the generation path's shapes ride beside the earlier rows, and its
    # errors join the entry's
    gk = tgen["kernels"]
    fp["fwd"]["shapes"] = fp["fwd"]["shapes"] + [gk["flash"]]
    fp["fwd"]["max_abs_err"] = max(fp["fwd"]["max_abs_err"],
                                   gk["flash"]["max_abs_err"])
    lp["shapes"] = lp["shapes"] + gk["ln"] + tspec["ln_rows"]
    lp["max_abs_err"] = max([lp["max_abs_err"]]
                            + [r["max_abs_err"]
                               for r in gk["ln"] + tspec["ln_rows"]])
    fwd_paths = {}
    for name in CNNS:
        fwd_paths[f"{name}_serve"] = serve[name]
        fwd_paths[f"{name}_train"] = train[name]["fwd"]
    bwd_paths = {f"{name}_train": train[name]["bwd"] for name in CNNS}
    for path, counts in (("resnet50_knobs", rknobs), ("checkpoint", ckpt)):
        fwd_paths[path] = counts["fwd"]
        bwd_paths[path] = counts["bwd"]
    # the mesh runs' launches, summed over the ranks: (pool fwd, pool
    # bwd, flash fwd, flash bwd, layernorm)
    ml = tmesh["launches"]
    for run in ("alexnet", "cnn_f32"):
        fwd_paths[f"mesh_{run}"] = ml[run][0]
        bwd_paths[f"mesh_{run}"] = ml[run][1]
    mesh_flash = {f"mesh_{run}": ml[run] for run in (
        "bert_n2c2", "tf_f32_n2c2", "bert_reshard", "bert_f32_reshard",
        *SEARCH_MESH_RUNS)}
    mesh_ln = {f"mesh_{run}": ml[run][4] for run in (
        "bert_n2c2", "bert_s2c2", "tf_f32_n2c2", "tf_f32_s2c2", "pipe_p4",
        "pipe_n2p2", "pipe_f32_p4", "pipe_f32_n2p2", "bert_reshard",
        "bert_f32_reshard", "gen_n2c2", "gen_f32_n2c2", *SEARCH_MESH_RUNS)}
    # measure mode's launches while it timed the candidate partitions
    sl = tsearch["launches"]
    fwd_paths["search_measure_alexnet"] = sl["search_measure_alexnet"][0]
    bwd_paths["search_measure_alexnet"] = sl["search_measure_alexnet"][1]
    search_bert = {"search_measure_bert": sl["search_measure_bert"]}
    # the calibration phase's launches while it timed each graph's ops
    # (harvest and error sweep)
    cl = tcalib["launches"]
    for name in ("alexnet", "inception_v3"):
        fwd_paths[f"calibration_{name}"] = cl[name][0]
        bwd_paths[f"calibration_{name}"] = cl[name][1]
    search_bert["calibration_bert"] = cl["bert"]
    # the frontends' paths (the runner's subprocess counts apart: its
    # counts are its own process's, asserted in the phase)
    for path, key in (("frontends_nn_alexnet", "nn"),
                      ("frontends_keras_alexnet", "keras")):
        fwd_paths[path] = tfront[key]["fwd"]
        bwd_paths[path] = tfront[key]["bwd"]
    # the tooling phase's runner script (its subprocess's own counts,
    # printed by the script and asserted in the phase)
    fwd_paths["tooling_metrics_alexnet"] = ttool["alexnet"]["fwd"]
    bwd_paths["tooling_metrics_alexnet"] = ttool["alexnet"]["bwd"]
    # the example scripts run by the runner in this process (counts in
    # kernel_counters' order)
    fwd_paths["examples_alexnet"] = tex["examples_alexnet"][3]
    bwd_paths["examples_alexnet"] = tex["examples_alexnet"][4]
    ex_tf = tex["examples_transformer"]
    # the C API's programs in this process (counts in kernel_counters'
    # order) and test_capi.c's block at BERT-base's widths
    fwd_paths["capi_alexnet"] = tcapi["alexnet"][3]
    bwd_paths["capi_alexnet"] = tcapi["alexnet"][4]
    capi_tf = {"capi_test_transformer": tcapi["test_capi"],
               "capi_bert_block": tcapi["bert"]["launches"]}
    kp["max_abs_err"] = max(kp["max_abs_err"], tfront["keras"]["err_fwd"],
                            tcapi["err_fwd"])
    bp["max_abs_err"] = max(bp["max_abs_err"], tfront["keras"]["err_bwd"],
                            tcapi["err_bwd"])
    lp["max_abs_err"] = max(lp["max_abs_err"], tfront["ln"]["err"],
                            tcapi["err_ln"])
    lp["max_abs_err"] = max(lp["max_abs_err"], tpipe["max_abs_err"])
    print(json.dumps({"kernels": [
        entry("max_pool_nhwc", "flexflow_tpu/ops/pallas_pool.py:89",
              fwd_paths, kp),
        entry("max_pool_nhwc_bwd", "flexflow_tpu/ops/pallas_pool.py:97",
              bwd_paths, bp),
        call_entry("flash_attention_fwd", flash_src,
                   "flexflow_tpu/ops/attention.py:81",
                   {"transformer_serve": tserve["fwd"],
                    "transformer_train": ttrain["fwd"],
                    "bert_remat": bremat["fwd"],
                    "bert_accumulate": baccum["fwd"],
                    "bert_pinned": bpin["fwd"],
                    "generation": tgen["fwd"],
                    "generation_reference": tgen["ref_fwd"],
                    "bert_int8_serve": tquant["fwd"],
                    **tspec["fwd"], **tdis["fwd"],
                    "fleet": tfleet["fwd"],
                    **{k: v[2] for k, v in mesh_flash.items()},
                    **{k: v[2] for k, v in search_bert.items()},
                    "tooling_bert_traced": ttool["bert"]["fwd"],
                    **tbench["fwd"], "examples_transformer": ex_tf[0],
                    **{k: v[0] for k, v in capi_tf.items()}},
                   fp["fwd"]),
        call_entry("flash_attention_bwd", flash_src,
                   "flexflow_tpu/ops/attention.py:81",
                   {"transformer_train": ttrain["bwd"],
                    "bert_remat": bremat["bwd"],
                    "bert_accumulate": baccum["bwd"],
                    "bert_pinned": bpin["bwd"],
                    **{k: v[3] for k, v in mesh_flash.items()},
                    **{k: v[3] for k, v in search_bert.items()},
                    "tooling_bert_traced": ttool["bert"]["bwd"],
                    "examples_transformer": ex_tf[1],
                    **{k: v[1] for k, v in capi_tf.items()}},
                   fp["bwd"]),
        call_entry("fused_layernorm",
                   "flexflow_tpu_torch/csrc/fused_layernorm.cu",
                   "flexflow_tpu/ops/pallas_norm.py:143",
                   {"transformer_serve": tserve["ln"],
                    "transformer_train": ttrain["ln"],
                    "bert_remat": bremat["ln"],
                    "bert_accumulate": baccum["ln"],
                    "bert_pinned": bpin["ln"],
                    "generation": tgen["ln"],
                    "bert_int8_serve": tquant["ln"],
                    **tspec["ln"], **tdis["ln"],
                    "fleet": tfleet["ln"], "pipeline": tpipe["ln"],
                    **mesh_ln,
                    **{k: v[4] for k, v in search_bert.items()},
                    "frontends_keras_ln": tfront["ln"]["ln"],
                    "tooling_bert_traced": ttool["bert"]["ln"],
                    **tbench["ln"], "examples_transformer": ex_tf[2],
                    **{k: v[2] for k, v in capi_tf.items()}}, lp),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mesh-rank"]:
        sys.exit(mesh_rank_main(sys.argv[2:]))
    if sys.argv[1:2] == ["--mesh-nccl"]:
        sys.exit(mesh_nccl_main(sys.argv[2:]))
    if sys.argv[1:2] == ["--elastic-rank"]:
        sys.exit(elastic_rank_main(sys.argv[2:]))
    if sys.argv[1:2] == ["--lockwatch"]:
        sys.exit(lockwatch_main(sys.argv[2:]))
    sys.exit(main())
