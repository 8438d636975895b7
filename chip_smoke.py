#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--seed N] [--out build/chip_smoke.json]
    python3 chip_smoke.py --step-probe [--out ...]

Run from the repository root on a host with one CUDA card (Hopper: the
kernels are built for sm_90a). Phases, each fatal on failure, each
opened by the host microseconds of one eager launch (a one-element add,
the floor under a serving step's ~5,600 launches) and followed by its
wall seconds, each on a line of its own:

1. build   -- nvcc builds every kernel of the paths from src/repro_torch/csrc
              (seven sources, one nvcc each, all started together) into
              build/; ptxas's registers and spills, and the shared memory
              of its ring, for each instance of the wgmma + TMA skeleton
              (csrc/hopper_gemm.cuh's ring_kernel), of the two packed
              kernels' tensor-core templates, of the two attention
              kernels' tensor-core routes (csrc/attention_tc.cuh) and of
              the decode kernel's (its R 6 instances at qwen2.5-14b's 8 KV
              heads, the others at gemma2-2b's 4);
2. kernels -- each kernel against its plain PyTorch version on the card, at
              the shapes its path gives it at gemma2-2b widths (serving for
              the GEMV: its tensor-core route at M = 8 decode lanes, 16 to
              256 prefill rows and six ragged M, every lane tile it is
              built for, bit-exact on integer-valued x, its CUDA-core route
              for fp32 and unaligned bf16 x; also at qwen2.5-14b's six
              projections at M = 8, bit-exact, timed beside torch.matmul;
              paged decode's tensor-core
              route over bf16 and int8 pools, global and windowed, at hd
              64 to 256, R 1 to 8 and pages of 8 to 32 rows, and at each
              other dense id's decode shape (hd 128: R 6 over 8 KV heads,
              qwen2.5-14b; R 1 over 48, qwen1.5-32b; R 8 over 8,
              qwen1.5-110b; global, no softcap), with exact
              cases (q = 0, integer V: the mean of the valid rows, within
              1e-6) and two launches bit-identical, its CUDA-core kernel
              timed on the same inputs at phase 3's and phase 9's shapes;
              the flash prefill (also at qwen2.5-14b's hd 128, 48 q over
              8 KV heads, no softcap, S = 64 and 1,024, beside SDPA,
              the same function there) and the paged prefix attention;
              one training
              microbatch for the weight backward), with the stated
              tolerance (per element for the two prefill kernels, whose
              query rows are scaled so the softcap binds: the flash
              prefill's tensor-core route at phase 3's buckets 16 to 1024,
              with and without windows, at each head dim, its CUDA-core
              route on fp32; the prefix kernel's tensor-core route over
              bf16 and int8 pools, 32 to 256 tail rows, a window and a
              garbage-padded page list; both routes asserted and counted,
              the CUDA-core kernels also timed on the same bf16 inputs);
              both tensor-core routes where a layout error cannot hide (q
              = 0, no softcap, integer V, a window and GQA: each output the
              mean of its valid V rows, to a few fp32 ulps); the weight backward's
              tensor-core route also bit-exact on small-integer operands at
              each projection's shape, and its CUDA-core route at alpha > 0,
              int8 x and a ragged bf16 shape; the two ±1 GEMMs
              (boolean_matmul in counts and fused-threshold mode,
              packed_xnor_matmul) bit-exact at the four ±1-input convs of
              VGG-SMALL at batch 100, one SMALL-EDSR block conv and a ragged
              shape, packed_xnor_matmul also on random words (random pad
              bits, K not a multiple of 32); kernel, plain-version and
              library times (CUDA
              events, median of 20 launches, L2 flushed before each) beside
              the bound (packed_xnor_matmul's at the binary tensor cores'
              rate, measured by the library's rate probe), and
              boolean_matmul's operand copy alone;
3. serve   -- gemma2-2b at its published widths (26 layers, d_model 2304,
              vocab 256000, bf16), packed Boolean weights from the port's
              lm_init on a seeded generator, through ServeEngine.session:
              16 requests of 16..600 prompt tokens, 32 tokens each, some
              submitted mid-flight and one cancelled. The launch counters
              are zeroed just before and read just after; every kernel must
              have run exactly as often as the path calls it (the flash
              prefill once a layer of every prefill), every GEMV, flash
              prefill and paged decode launch on its tensor-core route;
4. check   -- a small fp32 model (gemma2-2b smoke widths, head_dim 64)
              served on the card with the kernels and on the CPU with the
              plain versions: logits within tolerance, greedy tokens
              identical, a session with greedy, seeded and session-keyed
              sampled lanes identical but for counted near-ties (the
              logits within 1e-3, and the card's token scoring, as
              logits / T + Gumbel, within 2 x (1e-3 / T + 2^-20 of 1 +
              |g| + |z|) of the CPU's winner; each later token of a parted
              stream held to the CPU's draw at its own context),
              generate and generate_eager (the contiguous cache, no paged
              decode) greedy and on the batch-level stream the same, also
              prefix-cached traffic with and without
              kv-quant; every GEMV, flash prefill, prefix attention and
              paged decode launch on its CUDA-core route (fp32);
5. train   -- gemma2-2b at its published widths, bf16, remat on, trained
              through make_train_step + TrainLoop with hybrid_optimizer
              (the launcher's cosine schedules) on the SyntheticLM
              pipeline: 4 sequences x 512 tokens a step in 2 microbatches,
              2 warm-up steps, then 5 timed steps with the launch counters
              zeroed just before; every Boolean projection's votes must have
              gone through boolean_weight_bwd (7 x 26 launches a
              microbatch), every launch on its tensor-core route. One more
              step runs under torch.profiler;
6. train check -- a small fp32 model (gemma2-2b smoke widths) trained 3
              steps on the card (kernels) and on the CPU (plain versions)
              from the same state each step: losses within tolerance, flip
              decisions identical except counted ties, FP leaves within
              tolerance (Adam's unsaturated elements counted), no launch
              on a tensor-core route, and a checkpoint of the card's
              params and optimizer state round-trips bit for bit;
7. prefix  -- gemma2-2b at its published widths served through
              ServeEngine(packed=True, prefix_cache=True).session, once
              over a bf16 KV pool and once with kv_cache_quant (int8 pools
              with fp32 per-row scales): a 512-token system prompt shared
              by 16 requests (distinct tails of 16..256 tokens, 32 tokens
              each; the first cold, the rest partial hits), then 4 repeats
              of earlier full prompts. Launch counters exact (flash prefill
              per cold prefill, paged prefix attention per tail prefill,
              paged decode per decode step, none for an exact hit), prefix
              statistics as expected, exact-hit streams bit-identical to
              the streams that seeded their records, pages conserved after
              the drain; each partial-hit stream's agreement with a cold run
              of its full prompt is read, and for the longest tail every
              layer, teacher-forced (each block of the tail fed the cold
              run's input to that block), must match the cold prefill's
              committed K/V rows and attention output at the same positions
              within bf16 roundings, element by element; every GEMV, flash
              prefill, prefix attention and paged decode launch on its
              tensor-core route, over both pools. TTFT by
              admission kind, the decode step and peak memory are reported;
8. vision  -- Boolean VGG-SMALL at published widths (stages 128/256/512,
              fc 1024, 32x32x3, 10 classes; weights from vgg_init on the
              seed) over 10 batches of 100 synthetic class-conditional
              images, evaluated with float-view, int8 and PackedBool
              Boolean leaves, without and with BN: launch counters exact (4
              a batch for the route's kernel, 0 for every other), the
              kernel routes' ±1 activations and predictions identical to
              the plain route's (the GEMMs' plain versions on the card) and
              to each other, the float route's (cuDNN) differences counted;
              3 training steps of the example (flip rule + Adam) at batch
              100; SMALL-EDSR (8 blocks, width 64, x2) on 4 x 128x128
              through the three leaf forms (8 launches a kernel forward,
              outputs identical to the plain route). Images/s per route;
9. qwen    -- qwen2.5-14b at its published widths (48 layers, d_model
              5120, 40 q heads padded to 48 over 8 KV heads, head_dim 128,
              q/k/v biases, rope theta 1e6, vocab 152064, bf16): lm_init on
              a seeded generator, packed with pack_weights(consume=True)
              (a stacked group slice at a time, each int8 leaf freed as it
              is packed; the peak memory of init + pack printed and held
              under 80 GB), served through ServeEngine(packed=True,
              max_len=1024).session: 8 lanes, 16 requests of phase 3's
              prompt lengths, 32 tokens each, 8 greedy, 4 at T = 0.8 with
              their own seeds and 4 at T = 0.8 on the session key, some
              submitted mid-flight and one cancelled. Launch counters
              exact (6 x 48 GEMV a decode step and a prefill of <= 256
              rows, 48 paged decode a step, 48 flash prefill a prefill),
              every launch on its tensor-core route, every decode launch
              at R = 6; decode step, tokens/s, TTFT, serving memory and
              one profiled 8-step segment by kernel group; the threefry
              bits on the card equal the CPU's and every recorded sampled
              draw of the segments equals the CPU's from the same logits
              but for counted near-ties (a differing token must score
              within a fixed bound of the CPU's winner: the log's ulps
              and the fp32 sum); decode_route_check holds one
              lane's paged decode step, every layer teacher-forced, to the
              plain full forward (new K/V rows and attention output within
              bf16 roundings) and to the exact attention over its own
              operands (tight enough that an fp16 or int8 rounding of the
              kernel's output fails it, asserted);
10. falcon -- falcon-mamba-7b at its published widths, depth cut to 32
              of its 64 mamba blocks (FALCON_LAYERS; d_model 4096,
              d_inner 8192, state 16, conv 4, dt_rank 256, vocab 65024,
              bf16): lm_init on a seeded generator, packed
              (pack_weights(consume=True)), served through
              ServeEngine(packed=True, max_len=1024).session: 8 lanes, 16
              greedy requests of phase 3's prompt lengths, 32 tokens each,
              some submitted mid-flight. Launch counters exact (5 x 32 GEMV
              a decode step and a prefill of <= 256 rows, no other kernel;
              its five shapes, x_proj's N = 288 and dt_proj's K = 256
              among them, bit-exact in phase 2), every launch on the
              tensor-core route; decode step, tokens/s, TTFT, memory and
              one profiled 8-step segment (GEMV, the selective scan's and
              other elementwise work, the head); ssm_state_check: prefill
              of S tokens then one decode step against the prefill of S +
              1, every layer teacher-forced, h and conv within stated
              tolerances (S = 100 and 300); then a prefix round on the same
              engine (a 512-token shared prompt, 8 requests, 4 exact
              repeats): exact-hit streams bit-identical to the streams that
              seeded their records, every stored page-boundary snapshot
              bit-identical to a rerun of the prefill that stored it, and
              tail_state_check holding a tail resumed from the boundary
              state to the cold prefill at every layer, teacher-forced;
              partial-hit streams against cold runs read, not checked;
11. families -- moonshot-v1-16b-a3b, arctic-480b and jamba-1.5-large-398b
              at smoke widths (head_dim 64) in fp32, served packed and on
              int8 leaves on the card (kernels) and on the CPU (plain
              versions): phase 4's
              mixed traffic identical but for counted near-ties, every
              launch on the CUDA-core routes and counted as the model's
              packed leaves and attention layers imply; jamba also
              prefix-cached, and one jamba request preempted and
              swap-resumed (ssm_swap_check: the lane's mamba state
              captured and restored bit for bit, streams card vs CPU);
              musicgen-medium's and internvl2-26b's lm_forward logits on
              embeddings within phase 4's tolerance.
12. moonshot -- moonshot-v1-16b-a3b at its published widths, depth cut
              to 24 of its 48 layers (MOON_LAYERS; d_model 2048, 16 q /
              16 KV heads of 128, 64 experts top-6, d_ff 1408, vocab
              163840, bf16): lm_init on a seeded
              generator, packed (pack_weights(consume=True); the int8
              experts stay the plain torch products of models/moe.py),
              served through ServeEngine(packed=True, max_len=1024).session:
              8 lanes, greedy, phase 3's first 8 prompt lengths, 32 tokens
              each. Launch counts equal the printed formula (2 x 24 GEMV a
              decode step and a prefill of <= 256 rows, 24 paged decode a
              step, 24 flash a prefill), every launch on the tensor-core
              routes; init + pack peak, resident memory, decode step,
              tokens/s, TTFT, device time by group for an admission round
              and an 8-step segment; moe_block_check (two MoE layers,
              teacher-forced: the router's top-6 against an fp64
              recompute outside near-ties, the output against the same
              function with fp64 expert products, the einsum and scatter
              dispatches against each other and timed);
13. overload -- gemma2-2b at published widths on a 192-page pool, bf16 and
              int8: swap_roundtrip_check (every byte of every leaf back on
              other page ids; d2h and h2d GB/s in chunks of 1, 8, 64
              pages); 24 fixed requests of 200 to 900 tokens over two
              tenants with page quotas, two priorities, three deadlines on
              an injected clock, a bounded queue and a host swap tier of
              150 pages, the audit clean after every step, every request
              terminal with the reference's reasons, swap-resumed and
              never-preempted streams token-identical to the same
              requests served without preemption, recompute-resumed ones
              read; four repeats of a 512-token prompt, close() and a
              session adopting the demoted index (promoted exact hit
              identical, tail_route_check on a partial hit over promoted
              pages); on the bf16 pool soak_session on
              FaultSchedule.random(0, DEFAULT_RATES, horizon=64), ok, with
              never-recomputed DONE streams equal to the fault-free run.
              Launches by route of the four serving kernels, all on the
              tensor cores.
14. gateway -- gemma2-2b at published widths (packed, bf16, max_len 1024)
              served over real HTTP on 127.0.0.1 through
              Gateway(engine, lanes=8, page_size=16, segment=8) and
              GatewayHTTP: phase 3's 16 prompts, 32 greedy tokens each, 8
              POSTed at once from client threads (http.client) and 8 once
              each of those has its first token event, plus one
              "stream": false request. Every SSE stream 32 token events
              and one end, token-identical to the same prompts served in
              process by engine.session(lanes=8, page_size=16, segment=8)
              (a differing stream fails with its first divergent step and
              logit margin); launches of the GEMV, decode and flash kernels
              equal the formula of phase 3 for the session's work, all on
              the tensor-core routes; /metrics' TTFT histogram counts every
              served request. Then: malformed bodies are 400s, a client
              that disconnects mid-stream is cancelled with its lane and
              pages freed, /healthz 200 then 503 draining after
              begin_drain() while the stream in flight ends with end; a
              second gateway of one lane and max_pending 2 sheds a 429
              queue-full with the live Retry-After; python -m
              repro_torch.launch.serve --arch gemma2-2b --packed --http
              PORT --lanes 8 --segment 8 as a process of its own (its
              kernel-build seconds, /healthz, two streams, SIGTERM, a drain
              and exit 0); a soak under FaultSchedule.random(seed,
              DEFAULT_RATES, horizon=48) with the prefix cache, the audit
              and a queue of 8 (a 512-token prompt, then seven sharing it:
              paged_prefix_attention on the partial hits), every stream
              ended typed and echoing its request_id, the audit clean.
              Prints TTFT over HTTP (client: POST to first token event)
              beside the in-process TTFT, the step thread's decode step
              beside the in-process one, tokens/s and the server's
              inter-token histogram.
15. mesh   -- tensor-parallel serving over torch.distributed on one card:
              make_serve_mesh(1), a one-rank NCCL world (make_serve_mesh(2)
              refused: one card), and gemma2-2b at published widths (packed,
              bf16, max_len 1024) through ServeEngine(mesh=): a 1,024-token
              prefill's logits torch.equal to phase 3's unsharded engine's,
              phase 3's traffic (16 requests, 32 greedy tokens, 8 lanes, the
              mid-flight submits and the cancel) with every stream
              identical to phase 3's, launches equal to phase 3's formula on
              the tensor-core routes, the collectives counted (one token
              check a segment; a mesh of one gathers no heads, as in the
              JAX package) and the head gather that a rank of a larger
              mesh issues before each wo timed over NCCL (device ms and
              host us a call, and the op that takes most of it), the
              decode step beside an unsharded engine's, in turns; then
              head_local_checks: at tp 2 and 4, every rank's head slice of
              paged_flash_decode (bf16 and int8 pools, global and windowed)
              and of flash_attention (a 1,024-token prefill), and every
              rank's shard-major column slice of the wqkv GEMV (M = 8 and
              128), with the unsharded plan pinned, torch.equal to the same
              heads or columns of the full launch, rank 0's slice timed
              beside its bound; and python -m repro_torch.launch.serve
              --packed --stream --shards 1 as a process of its own, its
              streams those of the same run in process, --shards 2 exiting
              non-zero with the oversubscription message.
16. train mesh -- multi-device training over torch.distributed on one
              card: make_local_mesh(1), a one-rank NCCL ("data", "model")
              world, and gemma2-2b at published widths (bf16, phase 5's
              traffic and seed) placed by the JAX package's training
              specs (launch/shardings.py: FSDP over "data", the heads,
              d_ff and vocab over "model") through
              make_train_step(grad_shardings=) and TrainLoop(shardings=),
              2 warm-up and 3 timed steps in turns with an unsharded run
              of the same steps: every loss and every leaf of params and
              optimizer state torch.equal after every step, no collective
              of any kind issued (every split one slice), the weight
              backward's launches counted (182 a microbatch, all on the
              tensor-core route), the step times and the peak memory; 3
              steps of
              ef_signsgd_compressed(hybrid_optimizer(...), ("data",)),
              layer 0's decoded votes and residuals held to
              compress_votes on the CPU (signs exact, the scale within
              1e-5, the residual within one bf16 ulp), flips, the
              compression's device ms and host us a step, the residual
              state's bytes, the peak and the int32 vote payload; one NCCL
              all-reduce of layer 0's fp32 grads and of its int32 votes,
              timed; the weight-backward launches a rank of a larger mesh
              makes (tp 2 and 4: column slices of the q/k/v votes
              torch.equal to the full launch's; dp 2 and 4: row blocks of
              the seven projections summed within tolerance), rank 0's
              timed beside its bound; and python -m
              repro_torch.launch.train --mesh local as a process of its
              own (exit 0), --model-axis 2 exiting non-zero with the
              divisibility message.
17. dry run -- the analytic launchers: python -m repro_torch.launch.dryrun
              on gemma2-2b × train_4k, prefill_32k and decode_32k × the
              single-pod (16, 16) mesh, each a process of its own on a fake
              world started once phase 16's host-timed sections are done
              (each ok; its peak a rank,
              bottleneck and roofline bound from the H100_SXM datasheet
              record, its collectives; its traced launches of row 3 in
              training and row 4 in the prefill); three one-rank cells at
              published widths, each traced on a fake world of one and then
              run on the card through the same entry points (train: phase
              5's traffic, 2 microbatches; prefill: one 32,768-token row
              through make_prefill_step on int8 leaves; decode: 8 rows over
              a 32,768-row contiguous cache, 16 steps through
              make_decode_step): the traced peak beside
              max_memory_allocated, the median step beside the roofline
              bound and its share of it, the card's launches a call equal
              to the trace's; train_16x16_rank0, rank 0 of gemma2-2b's
              train_4k on the 16 x 16 mesh under the JAX package's
              placement (4 rows x 4,096 tokens, its 4 microbatches cut to
              1), traced on the fake world and run on the card with real
              tensors over the same fake backend (launch.mesh.fake_world(
              device="cuda"): its collectives move nothing, so no value is
              compared): max_memory_allocated within 5% of the traced
              peak, the launches of row 3 equal to the trace's and all on
              the tensor-core route, the median step against its bound;
              prefill_16x16_rank0 and decode_16x16_rank0, rank 0 of
              gemma2-2b's prefill_32k (2 rows x 32,768 tokens, 1 of 16 q
              heads) and decode_32k (8 rows over a 2,048-row int8 slab, 16
              steps) under the same placement through
              make_prefill_step / make_decode_step(cfg, shardings), their
              traces the sweep's records: max_memory_allocated within 5%
              of the traced peak, the launches a call equal to the
              trace's (the prefill's 26 of row 4 all on the tensor-core
              route), the median against its bound, and row 4 at the
              prefill rank's head-local shape against its plain version at
              4,096 and 8,192 tokens; the traced launches' plans held to
              the libraries' tiles; and the achieved bf16 matmul (8192^3)
              and device-to-device copy (4 GiB) rates beside the record's
              peaks.
18. examples and families' training -- the three examples of the port
              through their own main on the card: quickstart (its acc >
              0.8; 2 launches of row 3 an epoch, CUDA cores), serve_lm
              plain, --packed and --packed --kv-quant (its four parity
              checks; launches by route), train_lm --full-100m (100
              steps, checkpoints at 50 and 100; step ms, tokens/s, loss,
              max_memory_allocated, row 3's launches equal to one a
              Boolean projection a layer a step, all on tensor cores),
              then a run that kept only the step-50 checkpoint, resumed
              with --resume (its losses the uninterrupted run's bit for
              bit); phase 6's check, one step, of falcon-mamba-7b,
              moonshot, arctic and jamba at smoke widths in fp32;
              falcon-mamba-7b trained at its published widths (its first
              16 of 64 blocks, FALCON_TRAIN_LAYERS; bf16) as phase 5
              trains gemma2-2b, on its traffic: step ms,
              tokens/s, peak, row 3's launches (5 a layer a microbatch,
              all on tensor cores) and one profiled step by group, the
              selective scan's among them.

The last lines are one JSON object of kernel results, the card's name and
power limit as nvidia-smi reports them, and the result object.

``--step-probe`` runs only phase 9's engine and its timed decode segments,
read in turn in one process (three times fresh, twice after a
torch.profiler session, after CPU matmuls, with the garbage collector
off), each beside the host cost of one launch, and prints the readings as
JSON: it says what in the earlier phases sets phase 9's decode step.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM published peaks (NVIDIA data sheet, dense): memory rate, bf16
# tensor-core rate, fp32 rate outside the tensor cores, int8 tensor-core
# rate (integer operations a second).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "fp32": 67e12, "int8": 1979e12}
GEMV_SHAPES = (("wqkv", 2304, 6144), ("wo", 4096, 2304),
               ("wgu", 2304, 18432), ("wd", 9216, 2304))
# qwen2.5-14b's six packed projections a block (q/k/v biases keep wq, wk
# and wv apart): (name, K, N)
QWEN_GEMV_SHAPES = (("wq", 5120, 6144), ("wk", 5120, 1024), ("wv", 5120, 1024),
                    ("wgu", 5120, 27648), ("wo", 6144, 5120),
                    ("wd", 13824, 5120))
FLUSH_BYTES = 1 << 30            # > the 50 MB L2; zeroing it keeps the card
                                 # busy ~0.3 ms while the host enqueues the
                                 # timed launch, so host time stays outside


def bound(bytes_moved: float, flops: float, kind: str, peak: float = None):
    """(least ms, what bounds it): the bytes over the memory rate or the
    operations over ``peak``, by default the published rate of ``kind``."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = flops / (peak or PEAK_FLOPS[kind])
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def time_ms(torch, fn, flush, iters: int = 20) -> float:
    """Median device time of ``fn`` over ``iters`` launches, each after an
    L2 flush, from CUDA events around the launch alone."""
    for _ in range(3):
        fn()
    marks = []
    for _ in range(iters):
        flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        marks.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in marks)


def tensor_core_rates(torch):
    """Integer operations a second of the binary (b1 AND-popc) and int8
    tensor cores, from csrc/packed_xnor_matmul.cu's rate probe: NVIDIA
    publishes no b1 rate for Hopper, so packed_xnor_matmul's bound is held
    to this measured one; the int8 probe, against the published 1,979 TOPS,
    shows how near the probe comes to a peak. Each the best of three
    launches of 2,000 groups on two blocks an SM, timed by CUDA events."""
    from repro_torch.kernels import build

    lib = build.library("packed_xnor_matmul")
    blocks, groups = 2 * 132, 2000
    out = torch.empty(blocks, dtype=torch.int32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    rates = {}
    for name, b1, bits in (("b1", 1, 256), ("int8", 0, 32)):
        best = math.inf
        for n in (20, groups, groups, groups):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            rc = lib.tc_rate_probe(b1, blocks, n, out.data_ptr(), stream)
            b.record()
            build.check("packed_xnor_matmul", "packed_xnor_matmul", rc)
            torch.cuda.synchronize()
            if n == groups:
                best = min(best, a.elapsed_time(b))
        ops = blocks * 2 * groups * 16 * 2.0 * 64 * 128 * bits
        rates[name] = ops / (best * 1e-3)
        print(f"  tensor-core rate probe {name}: {rates[name] / 1e12:.1f} TOPS "
              f"({best:.4f} ms for {ops:.4g} operations)")
    return rates


def zero_counts():
    """Every kernel's launch count, and the counts by route of the kernels
    with two routes, to 0."""
    from repro_torch.kernels import KERNELS

    for k in KERNELS:
        k.launches = 0
        if hasattr(k, "tc_launches"):
            k.tc_launches = k.cc_launches = 0


def route_counts():
    """{kernel: {"tensor_cores": n, "cuda_cores": n}} of the kernels with a
    tensor-core and a CUDA-core route."""
    from repro_torch.kernels import KERNELS

    return {k.__name__: {"tensor_cores": k.tc_launches,
                         "cuda_cores": k.cc_launches}
            for k in KERNELS if hasattr(k, "tc_launches")}


def smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# 2. kernel checks
# ---------------------------------------------------------------------------
# rows of x the GEMV is timed at: 8 decode lanes, and prefill buckets of 16
# to 256 rows (PACKED_GEMV_MAX_M), one at each lane tile of the tensor-core
# kernel; ragged rows inside each tile (and past 128, where tiles repeat) are
# checked, not timed
GEMV_M, GEMV_RAGGED_M = (8, 16, 32, 64, 128, 256), (5, 13, 29, 37, 100, 200)


def check_gemv(torch, flush, gen, shapes=GEMV_SHAPES, timed=GEMV_M,
               ragged=GEMV_RAGGED_M):
    """packed_xnor_gemv at one layer's projection shapes (by default
    gemma2-2b's four): the tensor-core route (bf16 x) at each M of
    ``timed`` and ``ragged`` (by default GEMV_M and GEMV_RAGGED_M, which
    between them run every lane tile the kernel is built for), bit-exact on
    integer-valued x (its fp32 sums are exact in any order, so a
    fragment-layout error cannot hide under the tolerance) and within the
    tolerance on random x; the CUDA-core route on fp32 x and on bf16 x at an
    unaligned base; kernel, plain-version and torch.matmul (bf16 ±1 weight)
    times beside the bound at each timed M, and the CUDA-core kernel's time
    on the same bf16 x one element past an aligned base (cc_ms: the design
    the tensor-core route replaced)."""
    from repro_torch.kernels import (gemv_route, pack_bits, packed_xnor_gemv,
                                     packed_xnor_gemv_plain)
    from repro_torch.kernels.packed_xnor import gemv_tc_plan, gemv_tc_tiles

    tiles = gemv_tc_tiles()
    rows, worst, tiles_run = [], 0.0, set()

    def check(label, x, wp, K, want_route):
        route = gemv_route(x, wp)
        y = packed_xnor_gemv(x, wp, k_valid=K)
        ref = packed_xnor_gemv_plain(x, wp, k_valid=K)
        torch.cuda.synchronize()
        err = (y - ref).abs().max().item()
        # fp32 sums of K bf16 terms in two association orders
        tol = 1e-5 * ref.abs().max().item() + 1e-4
        print(f"  gemv {label}: route {route}, max_abs_err={err:.3g} (tol "
              f"{tol:.3g})")
        assert route == want_route, (label, route)
        assert err <= tol, f"gemv {label}: {err} > {tol}"
        return err

    for name, K, N in shapes:
        w = (torch.randint(0, 2, (K, N), generator=gen, device="cuda",
                           dtype=torch.int8) * 2 - 1).to(torch.int8)
        wp = pack_bits(w, axis=0)
        w_bf16 = w.to(torch.bfloat16)
        for M in (*timed, *ragged):
            lanes = gemv_tc_plan(M, wp.shape[0], N, tiles)[0]
            tiles_run.add(lanes)
            xi = torch.randint(-3, 4, (M, K), generator=gen,
                               device="cuda").to(torch.bfloat16)
            same = bool(torch.equal(packed_xnor_gemv(xi, wp, k_valid=K),
                                    packed_xnor_gemv_plain(xi, wp, k_valid=K)))
            print(f"  gemv {name:4s} M={M:3d} K={K} N={N} ({lanes}-row tiles): "
                  f"integer-valued x bit-exact {same}")
            assert same, f"gemv {name} M={M}: integer-valued x differs"
            x = torch.randn((M, K), generator=gen, device="cuda").to(torch.bfloat16)
            err = check(f"{name:4s} M={M:3d} K={K} N={N}", x, wp, K,
                        "tensor_cores")
            worst = max(worst, err)
            if M in ragged:
                continue
            ms = time_ms(torch, lambda: packed_xnor_gemv(x, wp, k_valid=K), flush)
            plain = time_ms(torch, lambda: packed_xnor_gemv_plain(x, wp, k_valid=K),
                            flush)
            lib = time_ms(torch, lambda: torch.matmul(x, w_bf16), flush)
            xu = torch.empty((M * K + 1,), dtype=x.dtype, device=x.device)[1:]
            xu = xu.view(M, K).copy_(x)
            assert gemv_route(xu, wp) == "cuda_cores"
            cc = time_ms(torch, lambda: packed_xnor_gemv(xu, wp, k_valid=K), flush)
            b_ms, b_by = bound(x.numel() * 2 + wp.numel() * 4 + M * N * 4,
                               2.0 * M * K * N, "bf16")
            rows.append({"proj": name, "M": M, "K": K, "N": N,
                         "route": "tensor_cores", "max_abs_err": err,
                         "ms": ms, "plain_ms": plain, "library_ms": lib,
                         "cc_ms": cc, "bound_ms": b_ms, "bound_by": b_by})
            print(f"    kernel {ms:.4f} ms  plain {plain:.4f} ms  "
                  f"matmul(bf16 ±1) {lib:.4f} ms  CUDA-core kernel {cc:.4f} ms"
                  f"  bound {b_ms:.4f} ms ({b_by})")
        # the CUDA-core route: fp32 x (the small card-vs-CPU models) and bf16
        # x one element past an aligned base
        x32 = torch.randn((8, K), generator=gen, device="cuda")
        worst = max(worst, check(f"{name:4s} M=  8 fp32 x", x32, wp, K,
                                 "cuda_cores"))
        buf = torch.randn((8 * K + 1,), generator=gen,
                          device="cuda").to(torch.bfloat16)
        worst = max(worst, check(f"{name:4s} M=  8 bf16 x at an unaligned base",
                                 buf[1:].view(8, K), wp, K, "cuda_cores"))
    if ragged:
        assert tiles_run == set(tiles.blocks), ("gemv lane tiles not checked",
                                                set(tiles.blocks) - tiles_run)
    return rows, worst


# the decode kernel's other instances, each over both pools and in the
# exact case: (label, head dim, group size R, page, KV heads, windows,
# softcap); gemma2-2b's KV heads at window 100 and its softcap, then each
# other dense id's decode shape as its layers run it (global, no softcap):
# qwen2.5-14b's 40 q heads padded to 48 over 8 KV heads (R 6),
# qwen1.5-32b's 48 over 48 (R 1), qwen1.5-110b's 64 over 8 (R 8)
DECODE_SHAPES = (("hd 64", 64, 4, 16, 4, (100,), 50.0),
                 ("hd 128", 128, 4, 16, 4, (100,), 50.0),
                 ("R 1", 256, 1, 16, 4, (100,), 50.0),
                 ("R 2", 256, 2, 16, 4, (100,), 50.0),
                 ("R 8", 256, 8, 16, 4, (100,), 50.0),
                 ("page 8", 256, 4, 8, 4, (100,), 50.0),
                 ("page 32", 256, 4, 32, 4, (100,), 50.0),
                 ("qwen2.5-14b R 6", 128, 6, 16, 8, (0,), 0.0),
                 ("qwen1.5-32b R 1", 128, 1, 16, 48, (0,), 0.0),
                 ("qwen1.5-110b R 8", 128, 8, 16, 8, (0,), 0.0))
# the shape timed beside phase 3's: phase 9's (qwen2.5-14b)
QWEN_DECODE = DECODE_SHAPES[7]
# lane positions: pos 0, mid-page, page ends, the table's last row (1,023 at
# 1,024 rows a lane), one lane past its table (its writes go to the garbage
# page; all rows valid), or, for the exact case, far past it (under a
# 100-row window no row is valid: the lane averages every live row)
DECODE_POS = (0, 17, 100, 255, 511, 700, 1023, 1100)
DECODE_POS_FAR = (0, 17, 100, 255, 511, 700, 1023, 1500)


def decode_inputs(torch, gen, KV, R, hd, page, pos, exact=False, L=8,
                  max_len=1024):
    """Phase 2's decode operands: q (L, KV, R, hd) bf16, a permuted block
    table over L * C + 1 pages (lane 0 a short request, the rest of its
    table the garbage page 0), and a bf16 and an int8 pool pair (codes with
    per-(row, head) scales, |v| < ~5 like the bf16 pool). ``exact``: q = 0
    and integer V rows in [-2, 2] (int8 codes at scale 1.0), so every valid
    row weighs exactly 1 and each output is the exact mean of its rows."""
    C = max_len // page
    n_pages = L * C + 1
    shape = (n_pages, page, KV, hd)
    if exact:
        q = torch.zeros((L, KV, R, hd), dtype=torch.bfloat16, device="cuda")
    else:
        q = torch.randn((L, KV, R, hd), generator=gen,
                        device="cuda").to(torch.bfloat16)
    kp = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
    if exact:
        vp = torch.randint(-2, 3, shape, generator=gen,
                           device="cuda").to(torch.bfloat16)
    else:
        vp = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
    perm = torch.randperm(n_pages - 1, generator=gen, device="cuda") + 1
    bt = perm[:L * C].reshape(L, C).to(torch.int32).contiguous()
    bt[0, 1:] = 0                       # a short request: the rest garbage
    k8 = torch.randint(-127, 128, shape, generator=gen, device="cuda",
                       dtype=torch.int8)
    if exact:
        v8 = vp.to(torch.int8)
        ks = torch.ones(shape[:3], device="cuda")
        vs = torch.ones(shape[:3], device="cuda")
    else:
        v8 = torch.randint(-127, 128, shape, generator=gen, device="cuda",
                           dtype=torch.int8)
        ks = torch.rand(shape[:3], generator=gen, device="cuda") * 0.035 + 0.005
        vs = torch.rand(shape[:3], generator=gen, device="cuda") * 0.035 + 0.005
    pos = torch.tensor(pos, dtype=torch.int32, device="cuda")
    return q, bt, pos, {"bf16": (kp, vp, None, None), "int8": (k8, v8, ks, vs)}


def decode_rows(pos, page, C, window):
    """Key rows the outputs depend on: a lane's valid rows [lo, hi] of
    decode_window, or all its live rows when none is valid (it averages
    them, as the reference does)."""
    from repro_torch.kernels.paged_attention import decode_window

    rows = 0
    for p in pos:
        n_live, lo, hi = decode_window(p, page, C, window)
        rows += hi - lo + 1 if lo <= hi else n_live * page
    return rows


def check_paged_decode(torch, flush, gen, cfg):
    """paged_flash_decode against its plain version: at phase 3's shape
    (8 lanes over gemma2-2b's 16 padded q heads on 4 KV heads, head dim 256,
    16-row pages, 1,024 rows a lane, softcap 50) and phase 9's
    (qwen2.5-14b: 48 padded q heads on 8 KV heads, R 6, head dim 128, no
    softcap, global) over bf16 and int8 pools,
    global, gemma2's local window and a 100-row window, within 1e-4, on
    both routes (the CUDA-core kernel through the measurement hook on the
    same bf16 inputs, and through the wrapper on fp32 q, the route phases 4
    and 6 take); the exact case (q = 0, integer V) within 1e-6, where a
    wrong page, row, head, share or window edge moves a mean by whole units
    of that; each other instance of DECODE_SHAPES the same at window 100;
    two launches on the same inputs bit-identical; the route decode_route
    names asserted and counted; at phase 3's shape also with the pages in 1
    or 3 shares (64 or 22 tiles a block, the ring refilled many times). At
    phase 3's shape, kernel, CUDA-core kernel (cc_ms: the design the
    tensor-core route replaced, on the same inputs) and plain times beside
    the bound over the rows decode_rows counts, and the wrapper's host time
    a call (host_us: the Python and launch cost, no wait on the card)."""
    from repro_torch.kernels import (decode_route, paged_flash_decode,
                                     paged_flash_decode_plain)
    from repro_torch.kernels.paged_attention import _decode_launch

    KV, hd = cfg.kv_heads_padded(), cfg.head_dim_
    R = cfg.heads_padded() // KV
    softcap = cfg.attn_logit_softcap
    rows, worst, exact = [], {"tensor_cores": 0.0, "cuda_cores": 0.0}, {}

    def check(label, pool, args, window, tol, *, route="tensor_cores",
              hook=False, nsplit=None, cap=softcap):
        """Two launches on ``route``, through the wrapper (the route asserted
        and counted) or, with ``hook``, through _decode_launch with
        ``nsplit`` shares; held against the plain version and each other."""
        kw = dict(window=window, softcap_val=cap)
        if hook:
            out, again = (_decode_launch(route, *args, nsplit=nsplit, **kw)
                          for _ in range(2))
            label = f"{label} {route}" + ("" if nsplit is None
                                          else f" nsplit {nsplit}")
        else:
            assert decode_route(args[0], args[1]) == route, label
            counter = ("tc_launches" if route == "tensor_cores"
                       else "cc_launches")
            n0 = getattr(paged_flash_decode, counter)
            out = paged_flash_decode(*args, **kw)
            again = paged_flash_decode(*args, **kw)
            assert getattr(paged_flash_decode, counter) == n0 + 2, label
        ref = paged_flash_decode_plain(*args, **kw)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        same = bool(torch.equal(out, again))
        print(f"  paged decode {label} {pool} pool window {window}: "
              f"max_abs_err={err:.3g} (tol {tol}), repeat bit-identical {same}")
        assert bool(torch.isfinite(out).all()) and err <= tol, \
            f"paged decode {label} {pool} window {window}: {err} > {tol}"
        assert same, f"paged decode {label} {pool}: launches differ"
        if tol >= 1e-4:
            worst[route] = max(worst[route], err)
        return err

    def host_us(fn, n=100):
        """Host microseconds a call, the card kept ahead of the host."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        t = (time.perf_counter() - t0) / n * 1e6
        torch.cuda.synchronize()
        return t

    # phase 3's shape: random cases on both routes, timed side by side; then
    # phase 9's (qwen2.5-14b: 8 KV heads, R 6, hd 128, global, no softcap)
    page = 16
    C = 1024 // page
    _, q_hd, q_R, _, q_KV, _, q_cap = QWEN_DECODE
    timed = [("phase 3", KV, R, hd, softcap,
              (("global", 0), ("local", cfg.sliding_window),
               ("window-100", 100))),
             ("phase 9", q_KV, q_R, q_hd, q_cap, (("global", 0),)),
             MOON_DECODE]
    for phase, KV_, R_, hd_, cap, windows in timed:
        q, bt, pos, pools = decode_inputs(torch, gen, KV_, R_, hd_, page,
                                            DECODE_POS)
        for pool, (k_, v_, ks_, vs_) in pools.items():
            row_bytes = hd_ * k_.element_size() + (4 if ks_ is not None else 0)
            args = (q, k_, v_, bt, pos, ks_, vs_)
            for label, window in windows:
                # fp32 online softmax vs one softmax, |v| < ~5
                err = check(f"{phase} {label}", pool, args, window, 1e-4,
                            cap=cap)
                cc_err = check(f"{phase} {label}", pool, args, window, 1e-4,
                               route="cuda_cores", hook=True, cap=cap)
                kw = dict(window=window, softcap_val=cap)
                ms = time_ms(torch, lambda: paged_flash_decode(*args, **kw), flush)
                cc = time_ms(torch, lambda: _decode_launch("cuda_cores", *args, **kw),
                             flush)
                plain = time_ms(torch, lambda: paged_flash_decode_plain(*args, **kw),
                                flush)
                h_us = host_us(lambda: paged_flash_decode(*args, **kw))
                n_rows = decode_rows(DECODE_POS, page, C, window)
                b_ms, b_by = bound(q.numel() * 2 + n_rows * KV_ * row_bytes * 2
                                   + bt.numel() * 4 + pos.numel() * 4
                                   + q.numel() * 4,
                                   4.0 * n_rows * KV_ * R_ * hd_, "bf16")
                rows.append({"phase": phase, "pool": pool, "layer": label,
                             "window": window, "softcap": cap,
                             "L": len(DECODE_POS), "KV": KV_, "R": R_, "hd": hd_,
                             "page": page, "rows": n_rows, "max_abs_err": err,
                             "cc_max_abs_err": cc_err, "route": "tensor_cores",
                             "ms": ms, "cc_ms": cc, "plain_ms": plain,
                             "host_us": h_us, "library_ms": None,
                             "bound_ms": b_ms, "bound_by": b_by})
                print(f"    kernel {ms:.4f} ms  CUDA-core kernel {cc:.4f} ms  plain "
                      f"{plain:.4f} ms  bound {b_ms:.4f} ms ({b_by}, {n_rows} "
                      f"rows)  wrapper host {h_us:.1f} us a call; library: none "
                      "(no single PyTorch call computes attention over a paged "
                      "pool)")
    # the CUDA-core route as phases 4 and 6 reach it: fp32 q over fp32 and
    # int8 pools through the wrapper, random (1e-4) and exact (1e-6)
    for exact_case in (False, True):
        q_, bt_, pos_, pools_ = decode_inputs(
            torch, gen, KV, R, hd, page,
            DECODE_POS_FAR if exact_case else DECODE_POS, exact=exact_case)
        q_ = q_.float()
        kp_, vp_ = (t.float() for t in pools_["bf16"][:2])
        for pool, pargs in (("fp32", (kp_, vp_, None, None)),
                            ("int8", pools_["int8"])):
            args = (q_, pargs[0], pargs[1], bt_, pos_, *pargs[2:])
            for label, window in ((("global", 0), ("window-100", 100))
                                  if exact_case else
                                  (("global", 0), ("local", cfg.sliding_window),
                                   ("window-100", 100))):
                label = "fp32 q " + label + (" exact" if exact_case else "")
                err = check(label, pool, args, window,
                            1e-6 if exact_case else 1e-4, route="cuda_cores")
                if exact_case:
                    exact[f"{label} {pool}"] = err
                elif window == cfg.sliding_window:
                    h_us = host_us(lambda: paged_flash_decode(
                        *args, window=window, softcap_val=softcap))
                    rows.append({"pool": pool, "layer": label,
                                 "window": window, "route": "cuda_cores",
                                 "max_abs_err": err, "host_us": h_us})
                    print(f"    wrapper host {h_us:.1f} us a call")
    # the exact case at phase 3's shape, global and windowed, also with the
    # lanes' pages in 1 or 3 shares (the measurement hook): up to 64 tiles a
    # block through the ring, each stage refilled many times; every other
    # instance at window 100, random and exact
    for nsplit in (1, 3):
        for exact_case in (False, True):
            q_, bt_, pos_, pools_ = decode_inputs(
                torch, gen, KV, R, hd, 16,
                DECODE_POS_FAR if exact_case else DECODE_POS, exact=exact_case)
            for pool, (k_, v_, ks_, vs_) in pools_.items():
                args = (q_, k_, v_, bt_, pos_, ks_, vs_)
                for window in (0, 100):
                    err = check("phase 3" + (" exact" if exact_case else ""), pool,
                                args, window, 1e-6 if exact_case else 1e-4,
                                hook=True, nsplit=nsplit)
                    if exact_case:
                        exact[f"phase 3 nsplit {nsplit} {pool} window {window}"] = err
    cases = [("phase 3", hd, R, 16, KV, True, (0, 100), softcap)] + [
        (label, hd_, R_, page_, KV_, exact_case, windows, cap)
        for label, hd_, R_, page_, KV_, windows, cap in DECODE_SHAPES
        for exact_case in (False, True)]
    for label, hd_, R_, page_, KV_, exact_case, windows, cap in cases:
        q_, bt_, pos_, pools_ = decode_inputs(
            torch, gen, KV_, R_, hd_, page_,
            DECODE_POS_FAR if exact_case else DECODE_POS, exact=exact_case)
        for pool, (k_, v_, ks_, vs_) in pools_.items():
            args = (q_, k_, v_, bt_, pos_, ks_, vs_)
            for window in windows:
                if exact_case:
                    err = check(f"{label} exact", pool, args, window, 1e-6,
                                cap=cap)
                    exact[f"{label} {pool} window {window}"] = err
                else:
                    check(label, pool, args, window, 1e-4, cap=cap)
    return rows, worst, exact


def _live_pairs(S: int, window: int) -> int:
    """(query, key) pairs a causal (windowed) attention over S rows needs:
    sum over t of min(t + 1, window)."""
    if window <= 0 or window >= S:
        return S * (S + 1) // 2
    return window * (window + 1) // 2 + (S - window) * window


# gemma2-2b prefill of one layer (16 padded q heads over 4 KV heads, softcap
# 50): (label, S, window, dtype, head_dim). bf16 at head_dim 256 (the
# tensor-core route): phase 3's small buckets 16, 64 and 128, then 256 and
# 1024 with no window, gemma2's local window (4096, wider than S) and a
# 256-row window; each other head dim once; fp32 (the CUDA-core route)
FLASH_CASES = (("global", 16, 0, "bf16", 256), ("global", 64, 0, "bf16", 256),
               ("global", 128, 0, "bf16", 256), ("global", 256, 0, "bf16", 256),
               ("local", 256, 4096, "bf16", 256),
               ("global", 1024, 0, "bf16", 256),
               ("local", 1024, 4096, "bf16", 256),
               ("window-256", 1024, 256, "bf16", 256),
               ("global", 256, 0, "bf16", 64), ("global", 256, 0, "bf16", 128),
               ("global", 256, 0, "fp32", 256))
# qwen2.5-14b prefill of one layer (48 padded q heads over 8 KV heads, n_rep
# 6, head_dim 128, no softcap, no window): phase 9's largest bucket and a
# small one
QWEN_FLASH_CASES = (("global", 64, 0, "bf16", 128),
                    ("global", 1024, 0, "bf16", 128))


def check_flash(torch, flush, gen, cfg, cases=FLASH_CASES):
    """flash_attention_fwd at ``cases`` (by default FLASH_CASES, at
    gemma2-2b's heads) against its plain version, per element, at ``cfg``'s
    heads and softcap; the route flash_route names asserted and counted;
    kernel, plain-version and SDPA times beside the bound, and on bf16 the
    CUDA-core kernel's time on the same inputs (cc_ms: the design the
    tensor-core route replaced). Without softcap and window SDPA (causal,
    on the repeated KV heads) computes the same function: its time is then
    the library time."""
    from repro_torch.kernels import (flash_attention_fwd, flash_attention_plain,
                                     flash_route)
    from repro_torch.kernels.flash_attention import _launch

    H, KV = cfg.heads_padded(), cfg.kv_heads_padded()
    n_rep = H // KV
    rows, worst = [], 0.0
    for label, S, window, dt, hd in cases:
        dtype = torch.bfloat16 if dt == "bf16" else torch.float32
        # q x 8: scores of std ~8 reach |s| ~ 40, where the softcap of 50
        # moves them by up to ~10 (a kernel without the tanh fails); without
        # a softcap, peaked rows
        q = (8 * torch.randn((H, S, hd), generator=gen, device="cuda")).to(dtype)
        k = torch.randn((KV, S, hd), generator=gen, device="cuda").to(dtype)
        v = torch.randn((KV, S, hd), generator=gen, device="cuda").to(dtype)
        kw = dict(causal=True, window=window, softcap=cfg.attn_logit_softcap,
                  n_rep=n_rep)
        route = flash_route(q)
        assert route == ("tensor_cores" if dt == "bf16" else "cuda_cores"), route
        tc0 = flash_attention_fwd.tc_launches
        out = flash_attention_fwd(q, k, v, **kw).float()
        assert flash_attention_fwd.tc_launches - tc0 == (route == "tensor_cores")
        ref = flash_attention_plain(q, k, v, **kw).float()
        absv = flash_attention_plain(q, k, v.abs(), **kw).float()
        torch.cuda.synchronize()
        # per element. fp32: reassociation (2^-17 of sum p|v| / l). bf16:
        # both round p to bf16 before the value product, each against its
        # own running max, so each p_j may be one bf16 rounding off on
        # either side: 2^-7 of sum p|v| / l, plus 2^-12 of it for fp32
        # reassociation and the rounding inside absv; then one rounding of
        # each output to the nearest bf16, at most one ulp of the larger
        # apart
        if dt == "bf16":
            tol = (2.0 ** -7 + 2.0 ** -12) * absv \
                + 2.0 ** -7 * torch.maximum(out.abs(), ref.abs())
        else:
            tol = 2.0 ** -17 * absv
        diff = (out - ref).abs()
        err, ratio = diff.max().item(), (diff / tol).max().item()
        print(f"  flash prefill {label} S={S} window={window} {dt} hd {hd}: "
              f"route {route}, max_abs_err={err:.3g}, max err/tol {ratio:.3g}")
        assert bool(torch.isfinite(out).all()) and ratio <= 1.0, \
            f"flash {label} S={S} {dt} hd {hd}: err/tol {ratio}"
        worst = max(worst, err)
        ms = time_ms(torch, lambda: flash_attention_fwd(q, k, v, **kw), flush)
        cc = (time_ms(torch, lambda: _launch("cuda_cores", q, k, v, **kw), flush)
              if route == "tensor_cores" else None)
        plain = time_ms(torch, lambda: flash_attention_plain(q, k, v, **kw),
                        flush)
        kr, vr = (x.repeat_interleave(n_rep, 0)[None] for x in (k, v))
        sdpa = time_ms(torch, lambda: torch.nn.functional
                       .scaled_dot_product_attention(q[None], kr, vr,
                                                     is_causal=True), flush)
        pairs = H * _live_pairs(S, window)
        b_ms, b_by = bound((q.numel() * 2 + k.numel() * 2) * q.element_size(),
                           4.0 * hd * pairs, "bf16")
        same_fn = cfg.attn_logit_softcap == 0 and window == 0
        rows.append({"model": cfg.name, "case": label, "S": S,
                     "window": window, "dtype": dt,
                     "BH": H, "KV": KV, "hd": hd, "live_pairs": pairs,
                     "route": route, "max_abs_err": err,
                     "max_err_over_tol": ratio, "ms": ms, "cc_ms": cc,
                     "plain_ms": plain,
                     "library_ms": sdpa if same_fn else None,
                     "sdpa_causal_no_softcap_ms": sdpa, "bound_ms": b_ms,
                     "bound_by": b_by})
        print(f"    kernel {ms:.4f} ms"
              + (f"  CUDA-core kernel {cc:.4f} ms" if cc is not None else "")
              + f"  plain {plain:.4f} ms  bound {b_ms:.4f} ms ({b_by}); "
              + (f"library: sdpa(is_causal) {sdpa:.4f} ms" if same_fn else
                 "library: none (no single PyTorch call computes softcapped "
                 "or windowed attention); sdpa(is_causal, no softcap or "
                 f"window: not the same function) {sdpa:.4f} ms"))
    return rows, worst


# the prefix-cache tail prefill of phase 7: a 512-row prefix in 32 scattered
# pages of 16 rows, tail buckets of 128 and 256 rows (5 padded rows each),
# also under a 200-row window; and a 45-row prefix in 3 live pages bucketed
# to 4, the padding entry the garbage page 0 (filled with values that would
# wreck any row read from it); each other head dim once
PREFIX_ROWS, PREFIX_PAGE = 512, 16
# (tail bucket T, live prefix rows, page_ids entries, window, head_dim)
PREFIX_CASES = ((128, 512, 32, 0, 256), (256, 512, 32, 0, 256),
                (128, 45, 4, 0, 256), (128, 512, 32, 200, 256),
                (128, 512, 32, 0, 64), (128, 512, 32, 0, 128))


def prefix_pools(torch, gen, KV, hd, page=PREFIX_PAGE):
    """A bf16 and an int8 (+ fp32 scales) pool of 8 x 1024 rows and a random
    order of their pages but page 0, which holds the garbage values."""
    n_pages = 8 * (1024 // page) + 1
    shape = (n_pages, page, KV, hd)
    perm = (torch.randperm(n_pages - 1, generator=gen, device="cuda")
            + 1).to(torch.int32)
    kp = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
    vp = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
    k8 = torch.randint(-127, 128, shape, generator=gen, device="cuda",
                       dtype=torch.int8)
    v8 = torch.randint(-127, 128, shape, generator=gen, device="cuda",
                       dtype=torch.int8)
    ks = torch.rand(shape[:3], generator=gen, device="cuda") * 0.035 + 0.005
    vs = torch.rand(shape[:3], generator=gen, device="cuda") * 0.035 + 0.005
    kp[0], vp[0], ks[0], vs[0] = 1e4, 1e4, 1e3, 1e3     # the garbage page
    return {"bf16": (kp, vp, None, None), "int8": (k8, v8, ks, vs)}, perm


def check_prefix(torch, flush, gen, cfg):
    """paged_prefix_attention at PREFIX_CASES over a bf16 and an int8 pool
    against its plain version, per element, also with the key window in
    one share (no split); the route prefix_route names asserted and
    counted; kernel, plain-version and bound times, the same route's time
    in one share (one_share_ms) and the CUDA-core kernel's time on the same
    inputs (cc_ms)."""
    from repro_torch.kernels import (paged_prefix_attention,
                                     paged_prefix_attention_plain, prefix_route)
    from repro_torch.kernels.paged_attention import _prefix_launch

    H, KV = cfg.heads_padded(), cfg.kv_heads_padded()
    n_rep, page = H // KV, PREFIX_PAGE
    pools_by_hd = {}
    rows, worst = [], 0.0
    for T, prefix_len, npp, window, hd in PREFIX_CASES:
        if hd not in pools_by_hd:
            pools_by_hd[hd] = prefix_pools(torch, gen, KV, hd)
        pools, perm = pools_by_hd[hd]
        length = T - 5
        n_live = -(-prefix_len // page)
        page_ids = torch.zeros((npp,), dtype=torch.int32, device="cuda")
        page_ids[:n_live] = perm[:n_live]
        # q x 8: the softcap of 50 binds (scores of std ~8)
        q = (8 * torch.randn((H, T, hd), generator=gen, device="cuda")
             ).to(torch.bfloat16)
        kt = torch.randn((T, KV, hd), generator=gen, device="cuda").to(torch.bfloat16)
        vt = torch.randn((T, KV, hd), generator=gen, device="cuda").to(torch.bfloat16)
        for pool, (k_, v_, ks_, vs_) in pools.items():
            args = (q, kt, vt, k_, v_, page_ids, prefix_len, prefix_len,
                    length, ks_, vs_)
            kw = dict(n_rep=n_rep, window=window,
                      softcap_val=cfg.attn_logit_softcap)
            route = prefix_route(q, k_)
            assert route == "tensor_cores", route
            tc0 = paged_prefix_attention.tc_launches
            out = paged_prefix_attention(*args, **kw)
            assert paged_prefix_attention.tc_launches == tc0 + 1
            ref = paged_prefix_attention_plain(*args, **kw)
            absv = paged_prefix_attention_plain(
                q, kt, vt.abs(), k_, v_.abs(), page_ids, prefix_len,
                prefix_len, length, ks_, vs_, **kw)
            torch.cuda.synchronize()
            # per element: both cast p to bf16 before the value product,
            # each against its own running max, so each p_j may be one bf16
            # rounding off on either side: 2^-7 of sum p|v| / l, plus 2^-12
            # of it for fp32 reassociation and the rounding inside absv
            tol = (2.0 ** -7 + 2.0 ** -12) * absv
            one = _prefix_launch("tensor_cores", *args, **kw, nsplit=1)
            torch.cuda.synchronize()
            diff = torch.maximum((out - ref).abs(), (one - ref).abs())
            err, ratio = diff.max().item(), (diff / tol).max().item()
            print(f"  paged prefix {pool} pool T={T} (length {length}) over "
                  f"{prefix_len} prefix rows in {n_live} of {npp} pages, "
                  f"window {window}, hd {hd}: route {route}, max_abs_err="
                  f"{err:.3g}, max err/tol {ratio:.3g}")
            assert bool(torch.isfinite(out).all()) and ratio <= 1.0, \
                f"paged prefix {pool} T={T} prefix {prefix_len}: {ratio}"
            worst = max(worst, err)
            ms = time_ms(torch, lambda: paged_prefix_attention(*args, **kw),
                         flush)
            one_ms = time_ms(torch, lambda: _prefix_launch(
                "tensor_cores", *args, **kw, nsplit=1), flush)
            cc = time_ms(torch, lambda: _prefix_launch("cuda_cores", *args,
                                                       **kw), flush)
            plain = time_ms(torch, lambda: paged_prefix_attention_plain(
                *args, **kw), flush)
            row_bytes = hd * k_.element_size() + (4 if ks_ is not None else 0)
            lo = (lambda t: max(0, prefix_len + t - window + 1)) if window \
                else (lambda t: 0)
            pairs = H * sum(max(0, prefix_len - lo(t))
                            + max(0, min(t + 1, length)
                                  - max(0, lo(t) - prefix_len))
                            for t in range(T))
            b_ms, b_by = bound(q.numel() * 2 + kt.numel() * 2 * 2
                               + prefix_len * KV * row_bytes * 2
                               + page_ids.numel() * 4 + out.numel() * 4,
                               4.0 * hd * pairs, "bf16")
            rows.append({"pool": pool, "T": T, "length": length,
                         "prefix_rows": prefix_len, "live_pages": n_live,
                         "page_ids": npp, "window": window, "H": H, "KV": KV,
                         "hd": hd, "route": route, "live_pairs": pairs,
                         "max_abs_err": err, "max_err_over_tol": ratio,
                         "ms": ms, "one_share_ms": one_ms, "cc_ms": cc,
                         "plain_ms": plain, "library_ms": None,
                         "bound_ms": b_ms, "bound_by": b_by})
            print(f"    kernel {ms:.4f} ms  in one share {one_ms:.4f} ms  "
                  f"CUDA-core kernel {cc:.4f} ms  plain "
                  f"{plain:.4f} ms  bound {b_ms:.4f} ms ({b_by}); library: "
                  "none (no single PyTorch call computes softcapped attention "
                  "over a paged pool)")
    return rows, worst


def _uniform_tol(torch, mean, out_dtype):
    """A few fp32 ulps of the exact mean (both kernels' sums of integers
    and counts are exact, their division correctly rounded), and for a
    bf16 output its one rounding to the nearest bf16."""
    tol = 2.0 ** -21 * mean.abs() + 2.0 ** -40
    if out_dtype == torch.bfloat16:
        tol = tol + 2.0 ** -8 * mean.abs()
    return tol


# (S, window) of the flash cases: a 40-row window over 1,024 rows, and a
# ragged global sequence whose 128-row blocks span two heads
UNIFORM_FLASH = ((1024, 40), (100, 0))


def check_uniform(torch, gen, cfg):
    """Both tensor-core routes where a layout error cannot hide: q = 0 and
    no softcap, so every valid key weighs exactly 1 and each output row is
    the mean of its valid V rows; V integer-valued in [-2, 2], GQA (16 q
    over 4 KV heads), a window. Each output against that mean in fp64, to
    a few fp32 ulps (and one bf16 rounding of the flash output): a wrong
    mask, window, page, GQA head or V fragment moves a mean by at least
    1 / (count + 1), whole units of the tolerance."""
    from repro_torch.kernels import flash_attention_fwd, paged_prefix_attention

    H, KV, hd = cfg.heads_padded(), cfg.kv_heads_padded(), cfg.head_dim_
    n_rep = H // KV
    out = {}

    def ints(shape):
        return torch.randint(-2, 3, shape, generator=gen, device="cuda")

    for S, window in UNIFORM_FLASH:
        q = torch.zeros((H, S, hd), dtype=torch.bfloat16, device="cuda")
        k = torch.randn((KV, S, hd), generator=gen,
                        device="cuda").to(torch.bfloat16)
        v = ints((KV, S, hd)).to(torch.bfloat16)
        got = flash_attention_fwd(q, k, v, causal=True, window=window,
                                  softcap=0.0, n_rep=n_rep).double()
        pos = torch.arange(S, device="cuda")
        valid = pos[None, :] <= pos[:, None]
        if window:
            valid &= pos[:, None] - pos[None, :] < window
        w = valid.double()
        mean = (w @ v.double()) / w.sum(1, keepdim=True)   # (KV, S, hd)
        mean = mean.repeat_interleave(n_rep, 0)
        ratio = ((got - mean).abs()
                 / _uniform_tol(torch, mean, torch.bfloat16)).max().item()
        print(f"  uniform flash S={S} window={window}: max err/tol {ratio:.3g}")
        assert ratio <= 1.0, f"uniform flash S={S}: {ratio}"
        out[f"flash_S{S}_w{window}"] = ratio

    T, prefix_len, window, page = 128, 512, 200, PREFIX_PAGE
    n_pages = 2 * prefix_len // page + 1
    shape = (n_pages, page, KV, hd)
    perm = (torch.randperm(n_pages - 1, generator=gen, device="cuda")
            + 1).to(torch.int32)
    codes = ints(shape)
    pools = {"bf16": (codes.to(torch.bfloat16), None),
             "int8": (codes.to(torch.int8),
                      torch.ones(shape[:3], device="cuda"))}
    for npp, plen, win in ((32, prefix_len, window), (4, 45, 0)):
        n_live = -(-plen // page)
        page_ids = torch.zeros((npp,), dtype=torch.int32, device="cuda")
        page_ids[:n_live] = perm[:n_live]
        length = T - 5
        q = torch.zeros((H, T, hd), dtype=torch.bfloat16, device="cuda")
        kt = torch.randn((T, KV, hd), generator=gen,
                         device="cuda").to(torch.bfloat16)
        vt = ints((T, KV, hd)).to(torch.bfloat16)
        for name, (vp, sc) in pools.items():
            vp = vp.clone()
            vp[0] = 1e2 if name == "bf16" else 100          # the garbage page
            kp = torch.randn(shape, generator=gen, device="cuda")
            kp = kp.to(torch.bfloat16) if name == "bf16" else \
                (kp * 40).clamp(-127, 127).to(torch.int8)
            got = paged_prefix_attention(q, kt, vt, kp, vp, page_ids, plen,
                                         plen, length, sc, sc, n_rep=n_rep,
                                         window=win, softcap_val=0.0).double()
            prefix_v = vp.index_select(0, page_ids[:n_live].long()).reshape(
                -1, KV, hd)[:plen].double()
            keys_v = torch.cat([prefix_v, vt.double()])     # (plen + T, KV, hd)
            kpos = torch.cat([torch.arange(plen, device="cuda"),
                              plen + torch.arange(T, device="cuda")])
            kval = torch.cat([torch.ones(plen, dtype=torch.bool, device="cuda"),
                              torch.arange(T, device="cuda") < length])
            qpos = plen + torch.arange(T, device="cuda")
            valid = kval[None, :] & (kpos[None, :] <= qpos[:, None])
            if win:
                valid &= qpos[:, None] - kpos[None, :] < win
            w = valid.double()
            mean = torch.einsum("tk,kgd->gtd", w, keys_v) / w.sum(1)[None, :, None]
            mean = mean.repeat_interleave(n_rep, 0)
            ratio = ((got - mean).abs()
                     / _uniform_tol(torch, mean, torch.float32)).max().item()
            print(f"  uniform paged prefix {name} pool, T={T} over {plen} "
                  f"prefix rows in {n_live} of {npp} pages, window {win}: "
                  f"max err/tol {ratio:.3g}")
            assert ratio <= 1.0, f"uniform prefix {name} {plen}: {ratio}"
            out[f"prefix_{name}_{plen}_w{win}"] = ratio
    return out


# one training microbatch of phase 5 (2 sequences x 512 tokens) through each
# Boolean projection of a gemma2-2b layer: (name, M = fan-in, N = fan-out)
WBWD_TOKENS = 1024
WBWD_SHAPES = (("wq", 2304, 4096), ("wk", 2304, 1024), ("wv", 2304, 1024),
               ("wo", 4096, 2304), ("wg", 2304, 9216), ("wu", 2304, 9216),
               ("wd", 9216, 2304))


def check_weight_bwd(torch, flush, gen):
    """boolean_weight_bwd on both routes at one training microbatch's
    shapes: bf16 x and z at alpha 0 (the tensor-core route, every launch of
    phase 5) bit-exact on small-integer operands, whose fp32 sums are exact
    in any order, so a layout error cannot hide under the tolerance; random
    operands within the tolerance on both routes (alpha > 0, int8 x and a
    bf16 shape with M, N not multiples of 8 take the CUDA-core route);
    kernel, plain-version and torch.mm times."""
    from repro_torch.core import preactivation_alpha
    from repro_torch.kernels import (boolean_weight_bwd, boolean_weight_bwd_plain,
                                     weight_bwd_route)

    B = WBWD_TOKENS
    for name, M, N in WBWD_SHAPES:
        x = torch.randint(-2, 3, (B, M), generator=gen, device="cuda").to(torch.bfloat16)
        z = torch.randint(-2, 3, (B, N), generator=gen, device="cuda").to(torch.bfloat16)
        route = weight_bwd_route(x, z)
        y, ref = boolean_weight_bwd(x, z), boolean_weight_bwd_plain(x, z)
        torch.cuda.synchronize()
        same = bool(torch.equal(y, ref))
        print(f"  weight bwd {name} integer-valued bf16 x, z in [-2, 2] B={B} "
              f"M={M} N={N}: route {route}, bit-exact {same}")
        assert route == "tensor_cores" and same, (name, route, same)
    ffn_alpha = preactivation_alpha(1)          # the FFN's fan_in-1 window
    cases = [(name, M, N, torch.bfloat16, alpha) for name, M, N in WBWD_SHAPES
             for alpha in (0.0, ffn_alpha)]
    cases.append(("wg", 2304, 9216, torch.int8, 0.0))
    cases.append(("ragged", 2300, 1020, torch.bfloat16, 0.0))
    rows, worst = [], 0.0
    for name, M, N, x_dtype, alpha in cases:
        x = torch.randn((B, M), generator=gen, device="cuda")
        x = (torch.where(x >= 0, 1, -1).to(torch.int8) if x_dtype == torch.int8
             else x.to(x_dtype))
        z = torch.randn((B, N), generator=gen, device="cuda").to(torch.bfloat16)
        d = (torch.randn((B, N), generator=gen, device="cuda").to(torch.bfloat16)
             if alpha else None)
        route = weight_bwd_route(x, z, alpha)
        want = ("tensor_cores" if x_dtype == torch.bfloat16 and alpha == 0.0
                and name != "ragged" else "cuda_cores")
        assert route == want, (name, route, want)
        y = boolean_weight_bwd(x, z, d, alpha=alpha)
        ref = boolean_weight_bwd_plain(x, z, d, alpha=alpha)
        mm = (torch.mm(x.t(), z, out_dtype=torch.float32)
              if alpha == 0.0 and x.dtype == z.dtype else None)
        torch.cuda.synchronize()
        err = (y - ref).abs().max().item()
        mm_err = None if mm is None else (mm - ref).abs().max().item()
        # fp32 sums of B exact products in another association order
        tol = 1e-5 * ref.abs().max().item() + 1e-4
        label = f"{name} {str(x_dtype)[6:]} x, alpha={alpha:.4f}"
        print(f"  weight bwd {label} B={B} M={M} N={N}: route {route}, "
              f"max_abs_err={err:.3g} (tol {tol:.3g}"
              + ("" if mm_err is None else f"; torch.mm's {mm_err:.3g}") + ")")
        assert err <= tol, f"weight bwd {label}: {err} > {tol}"
        worst = max(worst, err)
        ms = time_ms(torch, lambda: boolean_weight_bwd(x, z, d, alpha=alpha), flush)
        plain = time_ms(torch, lambda: boolean_weight_bwd_plain(x, z, d, alpha=alpha),
                        flush)
        lib = (time_ms(torch, lambda: torch.mm(x.t(), z, out_dtype=torch.float32),
                       flush) if mm is not None else None)
        b_ms, b_by = bound(x.numel() * x.element_size() + z.numel() * 2
                           + (d.numel() * 2 if alpha else 0) + M * N * 4,
                           2.0 * B * M * N, "bf16")
        rows.append({"proj": name, "x_dtype": str(x_dtype), "alpha": alpha,
                     "B": B, "M": M, "N": N, "route": route,
                     "max_abs_err": err, "library_max_abs_err": mm_err,
                     "ms": ms, "plain_ms": plain, "library_ms": lib,
                     "bound_ms": b_ms, "bound_by": b_by})
        print(f"    {route} kernel {ms:.4f} ms  plain {plain:.4f} ms  mm(x.T, z) "
              f"{'-' if lib is None else f'{lib:.4f}'} ms  bound {b_ms:.4f} ms "
              f"({b_by})")
    return rows, worst


# the ±1-input Boolean convs of phase 8 as GEMMs (M pixels, K = 9·Cin, N =
# Cout): VGG-SMALL at batch 100 (stages 1 and 2), one SMALL-EDSR block conv
# on 4 x 128 x 128, and a ragged shape (K not a multiple of 16, M and N not
# of the 128 tile, N not of 4: the kernels' byte-load path)
GEMM_SHAPES = (("vgg s1c0", 25600, 1152, 256), ("vgg s1c1", 25600, 2304, 256),
               ("vgg s2c0", 6400, 2304, 512), ("vgg s2c1", 6400, 4608, 512),
               ("edsr block", 65536, 576, 64), ("ragged", 1000, 100, 70))
VGG_GEMMS = GEMM_SHAPES[:4]
# packed_xnor_matmul on random words: its function counts the pad bits past
# k_valid whatever they hold (M, K, N; K not a multiple of 32)
RANDOM_PAD_SHAPE = (1000, 1000, 136)


def check_bool_gemm(torch, flush, gen, rates):
    """boolean_matmul (counts and the fused threshold at tau 0) and
    packed_xnor_matmul at the phase-8 shapes, each bit-exact against its
    plain version; torch._int_mm (cuBLASLt int8) on the unpacked operands,
    the faster of w row-major and column-major, as the library yardstick
    where it takes the shape. boolean_matmul's time includes its operand
    preparation (w transposed, K padded), which is also timed alone; the
    bound of packed_xnor_matmul, which runs on the binary tensor cores,
    takes their measured rate (``rates``). Then packed_xnor_matmul on
    random words of both operands, bit-exact."""
    from repro_torch.kernels import (boolean_matmul, boolean_matmul_operands,
                                     boolean_matmul_plain, pack_bits,
                                     packed_xnor_matmul,
                                     packed_xnor_matmul_plain)

    rows = []
    for name, M, K, N in GEMM_SHAPES:
        x = torch.where(torch.rand((M, K), generator=gen, device="cuda") < 0.5,
                        1, -1).to(torch.int8)
        w = torch.where(torch.rand((K, N), generator=gen, device="cuda") < 0.5,
                        1, -1).to(torch.int8)
        xp, wp = pack_bits(x, axis=1), pack_bits(w, axis=0)
        Kw = xp.shape[1]
        # the yardstick only; the port never calls it. w is a stored weight,
        # so it is timed both row-major and column-major (cuBLASLt's int8
        # tensor-core kernels want B column-major), and the faster counts.
        lib_layouts = {}
        if K % 8 == 0 and N % 8 == 0 and M > 16:
            for layout, wl in (("row_major", w), ("col_major", w.t().contiguous().t())):
                try:
                    assert torch.equal(torch._int_mm(x, wl), torch._int_mm(x, w))
                    lib_layouts[layout] = time_ms(
                        torch, lambda wl=wl: torch._int_mm(x, wl), flush)
                except RuntimeError as e:
                    print(f"  torch._int_mm refused {name} ({layout} w): {e}")
        lib = min(lib_layouts.values()) if lib_layouts else None
        if lib_layouts:
            print(f"  torch._int_mm {name}: " + "  ".join(
                f"{k} w {v:.4f} ms" for k, v in lib_layouts.items()))
        ops = 2.0 * M * K * N
        xk, wt = boolean_matmul_operands(x, w)
        torch.cuda.synchronize()
        same = bool(torch.equal(wt[:, :K], w.t()) and not wt[:, K:].any()
                    and torch.equal(xk[:, :K], x) and not xk[:, K:].any())
        operands_ms = time_ms(torch, lambda: boolean_matmul_operands(x, w), flush)
        print(f"  boolean_matmul operands {name} (w transposed by the library's "
              f"transpose kernel, K padded to {xk.shape[1]}): bit-exact {same}, "
              f"{operands_ms:.4f} ms")
        assert same, f"boolean_matmul operands {name}: differ from w.t()"
        del xk, wt
        cases = (
            ("boolean_matmul counts", lambda: boolean_matmul(x, w),
             lambda: boolean_matmul_plain(x, w), M * K + K * N + 4 * M * N, lib,
             None),
            ("boolean_matmul fused", lambda: boolean_matmul(
                x, w, fuse_threshold=True, tau=0.0), lambda: boolean_matmul_plain(
                x, w, fuse_threshold=True, tau=0.0), M * K + K * N + M * N, None,
             None),
            ("packed_xnor_matmul", lambda: packed_xnor_matmul(xp, wp, k_valid=K),
             lambda: packed_xnor_matmul_plain(xp, wp, k_valid=K),
             4 * (M * Kw + Kw * N) + 4 * M * N, lib, rates["b1"]))
        for kernel, fn, plain_fn, nbytes, lib_ms, peak in cases:
            y, ref = fn(), plain_fn()
            torch.cuda.synchronize()
            same = bool(torch.equal(y, ref))
            err = (y.to(torch.int64) - ref.to(torch.int64)).abs().max().item()
            print(f"  {kernel} {name} M={M} K={K} N={N}: bit-exact {same} "
                  f"(max_abs_err {err})")
            assert same, f"{kernel} {name}: differs from its plain version"
            ms = time_ms(torch, fn, flush)
            plain = time_ms(torch, plain_fn, flush)
            b_ms, b_by = bound(nbytes, ops, "int8", peak)
            row = {"kernel": kernel, "shape": name, "M": M, "K": K, "N": N,
                   "max_abs_err": err, "ms": ms, "plain_ms": plain,
                   "library_ms": lib_ms, "bound_ms": b_ms, "bound_by": b_by}
            if lib_ms is not None:
                row["library_layouts_ms"] = lib_layouts
            if kernel != "packed_xnor_matmul":
                row["operands_ms"] = operands_ms
            rows.append(row)
            print(f"    kernel {ms:.4f} ms  plain {plain:.4f} ms  _int_mm "
                  f"{'-' if lib_ms is None else f'{lib_ms:.4f}'} ms  bound "
                  f"{b_ms:.4f} ms ({b_by})")
        del x, w, xp, wp
    M, K, N = RANDOM_PAD_SHAPE
    Kw = -(-K // 32)
    xp = torch.randint(-2 ** 31, 2 ** 31, (M, Kw), generator=gen, device="cuda",
                       dtype=torch.int32)
    wp = torch.randint(-2 ** 31, 2 ** 31, (Kw, N), generator=gen, device="cuda",
                       dtype=torch.int32)
    y = packed_xnor_matmul(xp, wp, k_valid=K)
    ref = packed_xnor_matmul_plain(xp, wp, k_valid=K)
    torch.cuda.synchronize()
    same = bool(torch.equal(y, ref))
    err = (y.to(torch.int64) - ref.to(torch.int64)).abs().max().item()
    print(f"  packed_xnor_matmul random words M={M} k_valid={K} (Kw={Kw}, "
          f"{32 * Kw - K} random pad bits a row) N={N}: bit-exact {same}")
    assert same, "packed_xnor_matmul: random pad bits differ from the plain version"
    rows.append({"kernel": "packed_xnor_matmul random pad bits",
                 "shape": "random words", "M": M, "K": K, "N": N,
                 "max_abs_err": err})
    return rows


# ---------------------------------------------------------------------------
# 3. serve gemma2-2b at published widths
# ---------------------------------------------------------------------------
KERNEL_GROUPS = (("packed_xnor_gemv", ("xnor_gemv",)),
                 ("paged_flash_decode", ("paged_decode", "decode_tc")),
                 ("flash_attention", ("flash_tc", "flash_fwd")),
                 ("gemm (head, cuBLAS)", ("gemm", "sm90_", "cutlass", "nvjet")))


def _profiled(torch, fn, steps=1, kernel_groups=KERNEL_GROUPS,
              rest="other kernels"):
    """Wall time of ``fn()`` (ended by a synchronize) and the device time of
    its kernels by ``kernel_groups`` (name, name fragments), the others
    under ``rest``, from torch.profiler (CUPTI)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    groups = {g: 0.0 for g, _ in kernel_groups}
    groups[rest] = 0.0
    n_kernels = 0
    for e in prof.events():
        if str(e.device_type) != "DeviceType.CUDA":
            continue
        ms = e.time_range.elapsed_us() / 1e3
        name = e.name.lower()
        n_kernels += 1
        for g, keys in kernel_groups:
            if any(k in name for k in keys):
                groups[g] += ms
                break
        else:
            groups[rest] += ms
    busy = sum(groups.values())
    return {"wall_ms": wall_ms, "steps": steps, "device_ms": busy,
            "device_events": n_kernels,
            "idle_share": (1 - busy / wall_ms) if busy else None,
            "device_ms_by_group": groups}


def profile_segment(torch, engine, prompts, n_tok, params_for=None, key=None,
                    **groups):
    """Device time by kernel group over an admission round of 8 prompts
    (their prefills) and then one decode segment at 8 busy lanes, from
    torch.profiler (CUPTI), against each one's wall time. ``params_for(i)``
    gives request i's SamplingParams (greedy by default), ``key`` the
    session key; ``groups``: ``_profiled``'s kernel_groups and rest."""
    from repro_torch.serve import SamplingParams

    if params_for is None:
        def params_for(i):
            return SamplingParams(max_tokens=n_tok)
    sess = engine.session(lanes=8, page_size=16, segment=8, key=key)
    for i, p in enumerate(prompts):
        sess.submit(p, params_for(i))
    admission = _profiled(torch, sess.step, **groups)   # admission round
    out = _profiled(torch, sess.step, sess.segment, **groups)  # a segment
    sess.close()
    out["admission"] = admission
    for label, r in (("admission round", admission),
                     (f"segment of {sess.segment} decode steps", out)):
        if not r["device_ms"]:
            print(f"  profiled {label}: the profiler reported no device time "
                  "(device breakdown not measured)")
            continue
        print(f"  profiled {label}: wall {r['wall_ms']:.1f} ms, device busy "
              f"{r['device_ms']:.2f} ms (idle share {r['idle_share']:.3f}), "
              f"{r['device_events']} device events")
        for g, ms in sorted(r["device_ms_by_group"].items(), key=lambda kv: -kv[1]):
            print(f"    {g}: {ms:.3f} ms")
    return out

# phase 3's traffic, served again through the serve mesh by phase 15: 16
# prompt lengths, 32 greedy tokens each, 10 submitted at once, the other 6
# after the first decode segment, request 3 cancelled at the third round
SERVE_LENS = (16, 40, 100, 200, 250, 600, 300, 20, 64, 130, 500, 33, 256, 90,
              480, 17)
SERVE_TOKENS, SERVE_FIRST_WAVE, SERVE_CANCEL = 32, 10, 3
# phase 3's full-bucket prefill, whose logits phase 15's mesh engine must
# equal bit for bit
LOGITS_PROMPT = 1024


def serve_traffic(torch, engine, prompts):
    """Phase 3's traffic through ``engine.session(lanes=8, page_size=16,
    segment=8)``, the launch counters zeroed just before. Returns (the
    session, its handles, submit and first-token times by request, the
    serving seconds)."""
    from repro_torch.serve import SamplingParams

    zero_counts()
    sess = engine.session(lanes=8, page_size=16, segment=8)
    submitted, first_at, handles = {}, {}, []

    def submit(i):
        submitted[i] = time.perf_counter()
        handles.append(sess.submit(prompts[i],
                                   SamplingParams(max_tokens=SERVE_TOKENS)))

    def note_first_tokens():
        now = time.perf_counter()
        for h in handles:
            if h.rid not in first_at and h.tokens_ready:
                first_at[h.rid] = now

    for i in range(SERVE_FIRST_WAVE):
        submit(i)
    steps = 0
    t_serve = time.perf_counter()
    while sess.step():
        steps += 1
        note_first_tokens()
        if steps == 2:                       # after the first decode segment
            for i in range(SERVE_FIRST_WAVE, len(prompts)):
                submit(i)
        if steps == 3:
            assert handles[SERVE_CANCEL].cancel()
    torch.cuda.synchronize()
    return sess, handles, submitted, first_at, time.perf_counter() - t_serve


def serve_launches(cfg, work):
    """The launches phase 3's formula expects of a session's ``work``: 4
    GEMV a layer per decode step and per prefill of <= 256 rows, a paged
    decode a layer per decode step, a flash prefill a layer per prefill."""
    d_steps = work["decode_steps"]
    gemv_prefills = sum(c for b, c in work["prefills"].items() if b <= 256)
    return {"packed_xnor_gemv": 4 * cfg.n_layers * (d_steps + gemv_prefills),
            "paged_flash_decode": cfg.n_layers * d_steps,
            "boolean_weight_bwd": 0,
            "flash_attention_fwd": cfg.n_layers * sum(work["prefills"].values()),
            "paged_prefix_attention": 0, "boolean_matmul": 0,
            "packed_xnor_matmul": 0}


def timed_segments_8(torch, engine, prompts):
    """The decode step of 8 busy lanes: the first 8 prompts admitted, then
    each later segment timed alone. Returns (ms a step by segment, decode
    tokens, their seconds)."""
    from repro_torch.serve import SamplingParams

    seg_ms, decode_tokens, decode_s = [], 0, 0.0
    sess = engine.session(lanes=8, page_size=16, segment=8)
    for i in range(8):
        sess.submit(prompts[i], SamplingParams(max_tokens=SERVE_TOKENS))
    while sess.step():
        if not sess.sched.pending and all(
                len(r.emitted) for r in sess.sched.active.values()):
            break
    while not sess.idle:
        before = sum(len(r.emitted) for r in sess.sched.active.values())
        lanes_live = len(sess.sched.active)
        torch.cuda.synchronize()
        t = time.perf_counter()
        sess.step()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        seg_ms.append(dt * 1e3 / sess.segment)
        decode_tokens += min(lanes_live * sess.segment,
                             lanes_live * SERVE_TOKENS - before)
        decode_s += dt
    sess.close()
    return seg_ms, decode_tokens, decode_s


def full_prefill_logits(torch, engine, prompt):
    """The last-position logits of a cold prefill of ``prompt`` through
    ``engine.prefill_commit`` (a page pool of its own, 16-row pages), on
    the host."""
    import numpy as np

    n = len(prompt) // 16
    pool = engine.init_pool(n + 1, 16, 1)
    logits = engine.prefill_commit(pool, prompt, len(prompt),
                                   np.arange(1, n + 1, dtype=np.int32), 16)[0]
    engine.release_pool(pool)
    return logits.cpu()


def serve(torch, seed: int):
    from repro_torch.configs import get_config
    from repro_torch.kernels import KERNELS
    from repro_torch.models import lm_init
    from repro_torch.serve import RequestStatus, ServeEngine

    cfg = get_config("gemma2-2b")
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    engine = ServeEngine(cfg, lm_init(cfg, gen), max_len=1024, packed=True)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    print(f"  gemma2-2b {cfg.n_layers} layers d_model {cfg.d_model} vocab "
          f"{cfg.vocab_size} {cfg.dtype}: init + pack {setup_s:.1f} s")

    import numpy as np
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab_size, (n,)).astype(np.int32)
               for n in SERVE_LENS]
    n_tok, cancel_rid = SERVE_TOKENS, SERVE_CANCEL

    torch.cuda.reset_peak_memory_stats()
    sess, handles, submitted, first_at, serve_s = serve_traffic(
        torch, engine, prompts)
    launches = {k.__name__: k.launches for k in KERNELS}
    routes = route_counts()
    gemv_routes = routes["packed_xnor_gemv"]
    peak = torch.cuda.max_memory_allocated()

    # the same run again, timed per segment, for the step and token rates
    seg_ms, decode_tokens, decode_s = timed_segments_8(torch, engine, prompts)

    profile = profile_segment(torch, engine, prompts[:8], n_tok)

    stats = sess.work
    d_steps = stats["decode_steps"]
    per_layer = 4 * cfg.n_layers
    want = serve_launches(cfg, stats)
    print(f"  served {len(handles)} requests in {serve_s:.2f} s: "
          f"{d_steps} decode steps, prefill buckets {dict(stats['prefills'])}")
    print(f"  launches {launches}, expected {want} ({per_layer} GEMV per decode "
          f"step and per prefill of <= 256 rows, {cfg.n_layers} paged decode "
          f"per decode step, {cfg.n_layers} flash prefill per prefill)")
    assert launches == want, (launches, want)
    for name in ("packed_xnor_gemv", "paged_flash_decode", "flash_attention_fwd"):
        assert launches[name] > 0, launches
    print(f"  launches by route {routes}")
    for name in ("packed_xnor_gemv", "flash_attention_fwd", "paged_flash_decode"):
        assert routes[name] == {"tensor_cores": want[name], "cuda_cores": 0}, \
            (name, routes[name])
    for h in handles:
        toks = h.tokens_so_far()
        assert all(0 <= t < cfg.vocab_size for t in toks), h.rid
        if h.rid == cancel_rid:
            assert h.status is RequestStatus.CANCELLED and len(toks) < n_tok
        else:
            assert h.status is RequestStatus.DONE and len(toks) == n_tok, \
                (h.rid, h.status, len(toks))
    ttft = [1e3 * (first_at[r] - submitted[r]) for r in first_at]
    metrics = {
        "requests": len(handles), "decode_steps": d_steps,
        "prefill_buckets": {str(b): c for b, c in stats["prefills"].items()},
        "serve_s": serve_s, "setup_s": setup_s,
        "ttft_ms_median": statistics.median(ttft),
        "ttft_ms_max": max(ttft),
        "step_ms_median": statistics.median(seg_ms),
        "decode_tokens_per_s": decode_tokens / decode_s,
        "max_memory_allocated_bytes": peak,
        "launches": launches, "gemv_routes": gemv_routes, "routes": routes,
        "profiled_segment": profile,
    }
    print(f"  decode {metrics['decode_tokens_per_s']:.1f} tokens/s at 8 lanes, "
          f"median step {metrics['step_ms_median']:.2f} ms, median TTFT "
          f"{metrics['ttft_ms_median']:.1f} ms, max_memory_allocated "
          f"{peak / 2**30:.2f} GiB")

    # finite logits of the expected shapes from the served weights
    from repro_torch.models import lm_prefill
    tokens = torch.from_numpy(prompts[0][None]).cuda()
    logits, _ = lm_prefill(cfg, engine.params, {"tokens": tokens})
    torch.cuda.synchronize()
    assert tuple(logits.shape) == (1, 1, cfg.vocab_padded), logits.shape
    assert bool(torch.isfinite(logits).all()), "non-finite prefill logits"
    # what phase 15's serve mesh must reproduce: every stream, and the
    # logits of one full-bucket prefill
    long_prompt = np.random.default_rng(seed + 15).integers(
        0, cfg.vocab_size, (LOGITS_PROMPT,)).astype(np.int32)
    ref = {"prompts": prompts, "streams": [h.tokens_so_far() for h in handles],
           "long_prompt": long_prompt,
           "logits": full_prefill_logits(torch, engine, long_prompt),
           "step_ms_median": metrics["step_ms_median"]}
    return engine, launches, metrics, ref


# ---------------------------------------------------------------------------
# prefix-cached traffic (phases 4, 7, 10 and 11)
# ---------------------------------------------------------------------------
def prefix_traffic(torch, engine, prompts, repeats, n_tok, *, lanes, page,
                   segment):
    """Request 0 alone (cold), then requests 1.. together (partial hits on
    the shared system prompt), then, once they are done, repeats of the
    prompts ``repeats`` (exact hits, or partial hits where no exact record
    exists). The launch counters are zeroed just before and read after the
    drain, and around the repeats' admission round. Returns the streams,
    each request's admission kind, TTFT by kind (the session's own
    submit-to-first-token stamps), decode step times, session stats,
    launch counts (by route for the kernels with two) and the session's
    prefix index (its nodes' SSM snapshots stay readable); the pages must
    be conserved after the drain."""
    from repro_torch.kernels import KERNELS
    from repro_torch.serve import SamplingParams

    cuda = engine.device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    zero_counts()
    sess = engine.session(lanes=lanes, page_size=page, segment=segment,
                          prefix_cache=True)
    handles, kinds, step_ms = [], {}, []

    def submit(i):
        handles.append(sess.submit(prompts[i], SamplingParams(max_tokens=n_tok)))

    def note_kinds():
        for h in handles:
            if h.rid not in kinds and h.tokens_ready:
                hit = h._req.hit
                kinds[h.rid] = ("cold" if hit is None else
                                "exact" if hit.exact else "partial")

    def drain():
        while True:
            sync()
            t = time.perf_counter()
            steps0 = sess.work["decode_steps"]
            if not sess.step():
                return
            sync()
            if sess.work["decode_steps"] > steps0:
                step_ms.append((time.perf_counter() - t) * 1e3 / segment)
            note_kinds()

    submit(0)
    drain()
    for i in range(1, len(prompts)):
        submit(i)
    drain()
    before = {k.__name__: k.launches for k in KERNELS}
    for i in repeats:
        submit(i)
    sess.step()                                  # the repeats' admission
    sync()
    repeat_round = {k.__name__: k.launches - before[k.__name__] for k in KERNELS}
    note_kinds()
    drain()
    launches = {k.__name__: k.launches for k in KERNELS}
    routes = route_counts()
    alloc = sess.sched.alloc                     # page conservation
    assert alloc.refs[0] == 1 and all(alloc.refs[p] == 0 for p in alloc.free_pages)
    assert not sess.sched.active
    assert sess.prefix.owned_pages + alloc.n_free == alloc.n_pages - 1
    audit = sess.audit()
    index = sess.prefix
    stats = {"decode_steps": sess.work["decode_steps"],
             "prefills": sum(sess.work["prefills"].values()),
             "tail_prefills": sum(sess.work["tail_prefills"].values()),
             "buckets": {str(b): c for b, c in (sess.work["prefills"]
                                                + sess.work["tail_prefills"])
                         .items()},
             "exact_admits": sess.work["exact_admits"],
             "prefix": dict(sess.prefix.stats)}
    sess.close()
    ttft, admit = {}, {}
    for h in handles:
        ttft.setdefault(kinds[h.rid], []).append(h.ttft_ms)
        admit.setdefault(kinds[h.rid], []).append(h.admit_ms)
    return {"streams": [h.tokens_so_far() for h in handles],
            "kinds": [kinds[h.rid] for h in handles], "ttft_ms": ttft,
            "admit_ms": admit,
            "step_ms": step_ms, "stats": stats, "launches": launches,
            "gemv_routes": routes["packed_xnor_gemv"], "routes": routes,
            "repeat_round_launches": repeat_round, "audit": audit,
            "index": index}


def expected_kinds(n, repeats, quant):
    """Request 0 cold, the rest of the first n partial; a repeat is exact
    where its prompt left an exact record — every prompt on a bf16 pool,
    only the cold one under kv-quant (a kv-quant tail prefill never seeds
    a record)."""
    return (["cold"] + ["partial"] * (n - 1)
            + ["exact" if (i == 0 or not quant) else "partial" for i in repeats])


# ---------------------------------------------------------------------------
# 4. small model: card (kernels) vs CPU (plain versions)
# ---------------------------------------------------------------------------
SMOKE_LOGIT_ATOL = 1e-3     # fp32 smoke logits card vs CPU: sums
                            # reassociated across 4 layers


def draw_scores(torch, engines, context, temp, noise_key, step, row=0,
                rows=1):
    """(the CPU's scores, the bound on a score's noise) of the draw of
    ``context``'s next token on two engines (card, CPU): the last-position
    logits / T plus the Gumbel noise of row ``row`` of a (rows, V) draw
    from ``noise_key`` folded with ``step``. The card's logits at the
    context are first held to the CPU's within SMOKE_LOGIT_ATOL; the bound
    is fixed by that tolerance, not by the measured difference:
    SMOKE_LOGIT_ATOL / T + 2^-20 of 1 + |g| + |z| (the two libraries'
    log in the Gumbel, the fp32 sum)."""
    import numpy as np
    from repro_torch.models import lm_prefill
    from repro_torch.serve.sampling import fold_in, gumbel

    cfg = engines[0].cfg
    tok = torch.from_numpy(np.asarray(context, np.int32)[None])
    lg = [lm_prefill(cfg, e.params, {"tokens": tok.to(e.device)})[0]
          [0, -1, :cfg.vocab_size].cpu().float() for e in engines]
    err = (lg[0] - lg[1]).abs().max().item()
    assert err <= SMOKE_LOGIT_ATOL, f"logits card vs CPU differ by {err}"
    g = gumbel(fold_in(noise_key, step), (rows, cfg.vocab_size))[row]
    z = lg[1] / float(temp) + g
    eps = SMOKE_LOGIT_ATOL / float(temp) + 2.0 ** -20 * (
        1.0 + g.abs().max().item() + z.abs().max().item())
    return z, eps


def streams_agree(torch, engines, outs, contexts, draws):
    """Card vs CPU token streams: identical, or differing only from a
    near-tie on. ``outs``: two lists of streams; ``contexts[i]``: stream
    i's prompt; ``draws(i, t)``: (temperature, noise key, step, row, rows)
    of stream i's token t (temperature <= 0: greedy, which must be
    identical). Where a sampled stream parts, the card's token must score
    within twice ``draw_scores``' bound of the CPU's winner at that
    context; from there on the card's stream follows its own context, and
    each later token must be the CPU's draw at that context or such a
    near-tie. Returns (identical streams, near-ties); fails at a
    difference that is not a near-tie."""
    import numpy as np

    same = ties = 0
    for i, (a, b) in enumerate(zip(*outs)):
        a, b = list(map(int, a)), list(map(int, b))
        if a == b:
            same += 1
            continue
        assert len(a) == len(b), f"stream {i}: {len(a)} vs {len(b)} tokens"
        t0 = next(j for j, (x, y) in enumerate(zip(a, b)) if x != y)
        for t in range(t0, len(a)):
            temp, key, step, row, rows = draws(i, t)
            assert temp > 0, f"greedy stream {i} differs card vs CPU at {t}"
            ctx = np.concatenate([np.asarray(contexts[i], np.int32),
                                  np.asarray(a[:t], np.int32)])
            z, eps = draw_scores(torch, engines, ctx, temp, key, step, row,
                                 rows)
            win = int(torch.argmax(z))
            if t > t0 and a[t] == win:
                continue
            off = (z[win] - z[a[t]]).item()
            print(f"    stream {i} token {t}: card {a[t]}, CPU winner {win}, "
                  f"score {off:.3g} under it, near-tie bound {2 * eps:.3g}")
            assert off <= 2 * eps, \
                f"stream {i} differs at token {t}: {off} > 2 x {eps}"
            ties += 1
    return same, ties


def agree_with_cpu(torch, seed: int):
    import numpy as np
    from repro_torch.configs import get_smoke
    from repro_torch.models import lm_init, lm_prefill
    from repro_torch.serve import SamplingParams, ServeEngine

    cfg = get_smoke("gemma2-2b").scaled(head_dim=64, dtype=torch.float32)
    params = lm_init(cfg, torch.Generator().manual_seed(seed))
    engines = [ServeEngine(cfg, params, max_len=128, packed=True, device=d)
               for d in ("cuda", "cpu")]
    rng = np.random.default_rng(seed + 1)
    prompts = [rng.integers(0, cfg.vocab_size, (n,)).astype(np.int32)
               for n in (7, 30, 64, 5, 21, 50)]
    tok = torch.from_numpy(prompts[2][None])
    lg = [lm_prefill(cfg, e.params, {"tokens": tok.to(e.device)})[0].cpu()
          for e in engines]
    err = (lg[0] - lg[1]).abs().max().item()
    print(f"  smoke fp32 prefill logits card vs CPU: max_abs_err={err:.3g}")
    assert err <= SMOKE_LOGIT_ATOL, err

    outs = []
    zero_counts()
    for e in engines:
        with e.session(lanes=4, page_size=16, segment=4) as s:
            hs = [s.submit(p, SamplingParams(max_tokens=12)) for p in prompts[:4]]
            s.step()
            s.step()
            hs += [s.submit(p, SamplingParams(max_tokens=12)) for p in prompts[4:]]
            s.step()
            hs[1].cancel()
            s.run_until_idle()
            outs.append([h.tokens_so_far() for h in hs])
    same = sum(a == b for a, b in zip(*outs))
    print(f"  smoke greedy streams identical card vs CPU: {same}/{len(prompts)}")
    assert outs[0] == outs[1], outs

    # the same traffic with sampled lanes: every third request greedy,
    # every third at T = 0.8 with its own seed, the rest at T = 0.8 on the
    # session's key folded with the request id
    from repro_torch.serve import PRNGKey
    from repro_torch.serve.sampling import fold_in
    skey = PRNGKey(seed + 3)

    def mixed(i):
        return SamplingParams(max_tokens=12, temperature=0.0 if i % 3 == 0
                              else 0.8, seed=seed + 100 + i if i % 3 == 1
                              else None)

    outs = []
    for e in engines:
        with e.session(lanes=4, page_size=16, segment=4, key=skey) as s:
            hs = [s.submit(p, mixed(i)) for i, p in enumerate(prompts[:4])]
            s.step()
            s.step()
            hs += [s.submit(p, mixed(i + 4))
                   for i, p in enumerate(prompts[4:])]
            s.step()
            hs[1].cancel()
            s.run_until_idle()
            outs.append([h.tokens_so_far() for h in hs])

    def lane_draw(i, t):
        sp = mixed(i)
        key = PRNGKey(sp.seed) if sp.seed is not None \
            else fold_in(skey, i).numpy().astype(np.uint32)
        return sp.temperature, key, t, 0, 1

    s_same, s_ties = streams_agree(torch, engines, outs, prompts, lane_draw)
    print(f"  smoke sampled session (greedy, seeded and session-keyed lanes) "
          f"card vs CPU: {s_same}/{len(prompts)} streams identical, "
          f"{s_ties} near-ties")
    routes = route_counts()
    print(f"  card sessions' launches by route {routes} (fp32)")
    for name in ("packed_xnor_gemv", "flash_attention_fwd", "paged_flash_decode"):
        assert routes[name]["tensor_cores"] == 0 \
            and routes[name]["cuda_cores"] > 0, (name, routes[name])

    # generate and generate_eager (the contiguous cache, no paged decode),
    # greedy and on the batch-level stream
    gprompts = np.stack([rng.integers(0, cfg.vocab_size, (24,))
                         for _ in range(3)]).astype(np.int32)
    gkey = PRNGKey(seed + 5)
    gen_agree = {}
    zero_counts()
    for name in ("generate", "generate_eager"):
        for label, temp, key in (("greedy", 0.0, None), ("sampled", 0.8, gkey)):
            outs = [getattr(e, name)(gprompts, 10, temperature=temp, key=key)
                    .cpu().numpy() for e in engines]
            g_same, g_ties = streams_agree(
                torch, engines, outs, gprompts,
                lambda i, t: (temp, gkey, t, i, len(gprompts)))
            gen_agree[f"{name} {label}"] = {"identical": g_same,
                                            "near_ties": g_ties}
            print(f"  smoke {name} {label} card vs CPU: {g_same}/"
                  f"{len(gprompts)} rows identical, {g_ties} near-ties")
    g_routes = route_counts()
    print(f"  card generate's launches by route {g_routes} (fp32)")
    assert g_routes["paged_flash_decode"] == {"tensor_cores": 0,
                                              "cuda_cores": 0}, \
        "generate reached the paged decode"
    assert g_routes["packed_xnor_gemv"]["tensor_cores"] == 0 \
        and g_routes["packed_xnor_gemv"]["cuda_cores"] > 0, g_routes

    # prefix-cached traffic, scaled down: a 32-token system prompt, 6 tails
    system = rng.integers(0, cfg.vocab_size, (32,)).astype(np.int32)
    tails = [rng.integers(0, cfg.vocab_size, (n,)).astype(np.int32)
             for n in (5, 17, 9, 30, 12, 3)]
    pfx_prompts = [np.concatenate([system, t]) for t in tails]
    repeats = (0, 2, 4)
    pfx = {}
    for quant in (False, True):
        qcfg = cfg.scaled(kv_cache_quant=quant)
        res = [prefix_traffic(torch, ServeEngine(qcfg, params, max_len=128,
                                                 packed=True, device=d),
                              pfx_prompts, repeats, 8, lanes=4, page=16,
                              segment=4)
               for d in ("cuda", "cpu")]
        label = "kv-quant" if quant else "bf16-layout fp32"
        want = expected_kinds(len(pfx_prompts), repeats, quant)
        assert res[0]["kinds"] == res[1]["kinds"] == want, \
            (res[0]["kinds"], res[1]["kinds"], want)
        n_same = sum(a == b for a, b in zip(res[0]["streams"],
                                            res[1]["streams"]))
        print(f"  smoke prefix traffic ({label}): kinds {res[0]['kinds']}; "
              f"streams identical card vs CPU {n_same}/{len(want)}")
        assert res[0]["streams"] == res[1]["streams"], \
            (res[0]["streams"], res[1]["streams"])
        assert res[0]["stats"]["prefix"] == res[1]["stats"]["prefix"]
        for name in ("packed_xnor_gemv", "flash_attention_fwd",
                     "paged_prefix_attention", "paged_flash_decode"):
            r = res[0]["routes"][name]
            assert r["tensor_cores"] == 0 and r["cuda_cores"] \
                == res[0]["launches"][name] > 0, (name, r)
        pfx["kv_quant" if quant else "fp32_pool"] = n_same
    return {"smoke_logits_max_abs_err": err, "smoke_streams_identical": same,
            "smoke_sampled_streams_identical": s_same,
            "smoke_sampled_near_ties": s_ties,
            "smoke_generate": gen_agree, "smoke_generate_routes": g_routes,
            "smoke_prefix_streams_identical": pfx,
            "smoke_gemv_routes": routes["packed_xnor_gemv"],
            "smoke_routes": routes}


# ---------------------------------------------------------------------------
# 5. train gemma2-2b at published widths
# ---------------------------------------------------------------------------
TRAIN_SEQ, TRAIN_BATCH, TRAIN_MICRO = 512, 4, 2
WARMUP_STEPS, TIMED_STEPS = 2, 5
TRAIN_GROUPS = (("boolean_weight_bwd", ("weight_bwd",)),
                ("gemm (cuBLAS)", ("gemm", "sm90_", "cutlass", "nvjet")))


def _device_groups(prof, groups):
    """Device ms by kernel group (first key match), the event count, and the
    ten device kernels with the most time."""
    out = {g: 0.0 for g, _ in groups}
    out["other kernels"] = 0.0
    by_name = {}
    n = 0
    for e in prof.events():
        if str(e.device_type) != "DeviceType.CUDA":
            continue
        n += 1
        name = e.name.lower()
        ms = e.time_range.elapsed_us() / 1e3
        by_name[e.name[:90]] = by_name.get(e.name[:90], 0.0) + ms
        for g, keys in groups:
            if any(k in name for k in keys):
                out[g] += ms
                break
        else:
            out["other kernels"] += ms
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return out, n, top


def vote_launches(torch, params) -> int:
    """Weight-backward launches a microbatch implies: one for each Boolean
    projection of each layer (a stacked block leaf counts its groups)."""
    from repro_torch.checkpoint.manager import _flatten

    return sum(p.shape[0] if key.startswith("blocks/") else 1
               for key, p in _flatten(params).items() if p.dtype == torch.int8)


def _counts():
    """(launches by kernel, launches by route) from the counters."""
    from repro_torch.kernels import KERNELS

    return ({k.__name__: k.launches for k in KERNELS}, route_counts())


SCAN_GROUP = "mamba scan (ops on (..., d_inner, N) tensors)"


def _scan_device_ms(prof, groups, tail):
    """Device ms by ``groups`` (``_device_groups``) with one more,
    SCAN_GROUP: the kernels launched by an aten op that reads a tensor of
    shape (..., *tail) — the selective scan's (B, Q, d_inner, N) tensors
    and A, forward, recompute and backward — taken out of the group their
    name falls in. -> (groups, event count, top ten kernels)."""
    out, n, top = _device_groups(prof, groups)

    def reads(shapes):
        for s in shapes or ():
            if s and isinstance(s[0], (list, tuple)):
                if reads(s):
                    return True
            elif len(s) >= 2 and tuple(s[-2:]) == tail:
                return True
        return False

    scan = 0.0
    for e in prof.events():
        if str(e.device_type) != "DeviceType.CPU" or not e.kernels:
            continue
        if not reads(e.input_shapes):
            continue
        for k in e.kernels:
            ms = k.duration / 1e3
            name = k.name.lower()
            g = next((g for g, keys in groups if any(x in name for x in keys)),
                     "other kernels")
            out[g] -= ms
            scan += ms
    out[SCAN_GROUP] = scan
    return out, n, top


def train(torch, seed: int, cfg, eta: float, scan_tail=None):
    """``cfg`` (published widths, bf16, remat on) trained through
    make_train_step + TrainLoop with hybrid_optimizer on cosine schedules
    from ``eta``: TRAIN_BATCH x TRAIN_SEQ tokens a step in TRAIN_MICRO
    microbatches, WARMUP_STEPS, then TIMED_STEPS with the counters zeroed
    just before (row 3 launched once a Boolean projection a layer a
    microbatch, all on tensor cores, and no other kernel), then one step
    under torch.profiler: step ms, tokens/s, peak, the accumulators' reach
    to the flip threshold, device ms by group. With ``scan_tail`` (d_inner,
    N), the profiler records shapes and the selective scan's ops get a
    group of their own (``_scan_device_ms``)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.optimizer import (cosine_schedule, hybrid_optimizer,
                                            tree_leaves)
    from repro_torch.data import make_pipeline
    from repro_torch.models import lm_init
    from repro_torch.train import TrainLoop, make_train_step

    gc_collect(torch)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    assert cfg.remat and cfg.dtype == torch.bfloat16
    total = WARMUP_STEPS + TIMED_STEPS + 1          # + the profiled step
    t0 = time.perf_counter()
    params = lm_init(cfg, torch.Generator(device="cuda").manual_seed(seed))
    opt = hybrid_optimizer(
        eta=cosine_schedule(eta, total, warmup=total // 20),
        fp_lr=cosine_schedule(1e-3, total, warmup=total // 20))
    loop = TrainLoop(make_train_step(cfg, opt, TRAIN_MICRO), params,
                     opt.init(params),
                     make_pipeline(cfg, TRAIN_SEQ, TRAIN_BATCH, seed=seed),
                     log_every=1)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in tree_leaves(params))
    n_bool = sum(p.numel() for p in tree_leaves(params) if p.dtype == torch.int8)
    per_mb = vote_launches(torch, params)
    print(f"  {cfg.name} {cfg.n_layers} layers, d_model {cfg.d_model}, vocab "
          f"{cfg.vocab_size}, {cfg.dtype}: {n_params / 1e9:.3f} G parameters "
          f"({n_bool / 1e9:.3f} G Boolean), init + optimizer state "
          f"{setup_s:.1f} s; {TRAIN_BATCH} x {TRAIN_SEQ} tokens a step in "
          f"{TRAIN_MICRO} microbatches, eta {eta} (cosine)")
    flips = []

    def one_step():
        torch.cuda.synchronize()
        t = time.perf_counter()
        loop.run(1, install_signal_handlers=False)
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t) * 1e3
        flips.append(sum(float(f) for f in
                         tree_leaves(loop.opt_state.boolean.flips)))
        return dt

    warm_ms = [one_step() for _ in range(WARMUP_STEPS)]
    zero_counts()
    step_ms = [one_step() for _ in range(TIMED_STEPS)]
    launches, routes = _counts()
    want = TIMED_STEPS * TRAIN_MICRO * per_mb
    peak = torch.cuda.max_memory_allocated()
    print(f"  launches over the {TIMED_STEPS} timed steps {launches}; weight "
          f"backward by route {routes['boolean_weight_bwd']}, expected {want} "
          f"({per_mb} a microbatch: one a Boolean projection a layer), all "
          "on tensor cores")
    assert launches == {k: (want if k == "boolean_weight_bwd" else 0)
                        for k in launches}, launches
    assert routes["boolean_weight_bwd"] == {"tensor_cores": want,
                                            "cuda_cores": 0}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=scan_tail is not None) as prof:
        prof_ms = one_step()
    if scan_tail is None:
        groups, n_events, top = _device_groups(prof, TRAIN_GROUPS)
    else:
        groups, n_events, top = _scan_device_ms(prof, TRAIN_GROUPS, scan_tail)
    busy = sum(groups.values())

    losses = loop.history
    assert len(losses) == total and all(math.isfinite(x) for x in losses), losses
    bool_leaves = [p for p in tree_leaves(loop.params) if p.dtype == torch.int8]
    assert all(bool(((w == 1) | (w == -1)).all()) for w in bool_leaves)
    # how near the flip rule's threshold the accumulators came: m·w >= 1
    # flips a weight
    near = max(float((m * w.to(m.dtype)).amax()) for m, w in zip(
        tree_leaves(loop.opt_state.boolean.accum), bool_leaves))
    tokens = TRAIN_BATCH * TRAIN_SEQ
    med = statistics.median(step_ms)
    metrics = {
        "config": {"arch": cfg.name, "n_layers": cfg.n_layers,
                   "d_model": cfg.d_model, "vocab_size": cfg.vocab_size,
                   "dtype": str(cfg.dtype), "remat": cfg.remat,
                   "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
                   "microbatches": TRAIN_MICRO},
        "params": n_params, "boolean_params": n_bool, "setup_s": setup_s,
        "losses": losses, "flips": flips, "eta": eta,
        "max_accum_times_w": near, "warmup_step_ms": warm_ms,
        "step_ms": step_ms, "step_ms_median": med,
        "tokens_per_s": tokens / (med / 1e3),
        "max_memory_allocated_bytes": peak, "held_before_bytes": base,
        "launches": launches, "weight_bwd_routes": routes["boolean_weight_bwd"],
        "expected_weight_bwd": want,
        "profiled_step": {"wall_ms": prof_ms, "device_ms": busy,
                          "device_events": n_events,
                          "idle_share": (1 - busy / prof_ms) if busy else None,
                          "idle_share_vs_median": (1 - busy / med) if busy
                          else None,
                          "device_ms_by_group": groups,
                          "top_kernels_ms": top},
    }
    print("  loss per step " + " ".join(f"{x:.4f}" for x in losses))
    print("  flips per step " + " ".join(f"{x:.0f}" for x in flips)
          + f" (largest accumulator x weight after the last step {near:.4g}; "
          "1 flips)")
    print(f"  median step {med:.1f} ms ({tokens / (med / 1e3):.0f} tokens/s), "
          f"max_memory_allocated {peak / 2**30:.2f} GiB ({base / 2**30:.2f} "
          f"held before)")
    if busy:
        print(f"  profiled step: wall {prof_ms:.1f} ms, device busy {busy:.1f} "
              f"ms (idle share {1 - busy / prof_ms:.3f}; against the timed "
              f"median step {1 - busy / med:.3f}), {n_events} device events")
        for g, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
            print(f"    {g}: {ms:.2f} ms ({ms / busy:.3f} of device time)")
        print("  kernels with the most device time:")
        for name, ms in top:
            print(f"    {ms:8.2f} ms  {name}")
    else:
        print("  profiled step: the profiler reported no device time "
              "(device breakdown not measured)")
    del loop, params, bool_leaves
    gc_collect(torch)
    return metrics


# ---------------------------------------------------------------------------
# 6. small model training: card (kernels) vs CPU (plain versions)
# ---------------------------------------------------------------------------
TRAIN_SMOKE_LOSS_ATOL = 1e-4     # fp32, votes and sums reassociated on the card
# an FP leaf card vs CPU; beyond it only where Adam's step is not saturated
# (|g| near eps), counted, at most 1% of the elements, and within two steps
# of the learning rate
TRAIN_SMOKE_FP_ATOL, TRAIN_SMOKE_FP_LR = 1e-4, 1e-3


def _to(tree, device):
    """A copy of a tree of dicts / NamedTuples / tensors on ``device``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return type(tree)(*(_to(v, device) for v in tree))
    return tree.to(device, copy=True)


def train_agree_with_cpu(torch, seed: int, arch: str, steps: int):
    """``steps`` make_train_step steps (2 microbatches, eta 1000) of
    ``arch``'s smoke config in fp32, the kernels on the card and the plain
    versions on the CPU, each step from the CPU's params and state on the
    same batch: loss within TRAIN_SMOKE_LOSS_ATOL, flips identical but ties
    at the threshold, FP leaves within TRAIN_SMOKE_FP_ATOL (Adam's
    unsaturated elements counted), no launch on a tensor-core route.
    -> (readings, the card's params and optimizer state after the last
    step)."""
    from repro_torch.checkpoint.manager import _flatten
    from repro_torch.configs import get_smoke
    from repro_torch.core.optimizer import hybrid_optimizer
    from repro_torch.data import make_pipeline
    from repro_torch.models import lm_init
    from repro_torch.train import make_train_step

    cfg = get_smoke(arch).scaled(dtype=torch.float32)
    params = lm_init(cfg, torch.Generator().manual_seed(seed))
    # eta 1000: weights flip at smoke width
    opt = hybrid_optimizer(eta=1000.0, fp_lr=TRAIN_SMOKE_FP_LR)
    state = opt.init(params)
    step = make_train_step(cfg, opt, 2)
    pipe = make_pipeline(cfg, 32, 4, seed=seed)
    loss_err = fp_err = 0.0
    flips = ties = loose = total = 0
    zero_counts()
    for i in range(steps):
        batch = {k: torch.from_numpy(v) for k, v in pipe.batch_at(i).items()}
        before = {k: v.clone() for k, v in _flatten(params).items()}
        p_c, s_c, m_c = step(_to(params, "cuda"), _to(state, "cuda"),
                             {k: v.cuda() for k, v in batch.items()})
        params, state, m_h = step(params, state, batch)      # CPU, in place
        err = abs(float(m_c["loss"]) - float(m_h["loss"]))
        assert err <= TRAIN_SMOKE_LOSS_ATOL, (arch, i, float(m_c["loss"]),
                                              float(m_h["loss"]))
        loss_err = max(loss_err, err)
        card, host = _flatten(p_c), _flatten(params)
        acc_c = _flatten(s_c.boolean.accum)
        acc_h = _flatten(state.boolean.accum)
        for key, w0 in before.items():
            wc, wh = card[key].cpu(), host[key]
            if w0.dtype == torch.int8:
                flips += int((wh != w0).sum())
                differ = wc != wh
                if differ.any():
                    # one side flipped and the other did not: a tie only if
                    # the side that kept its weight sits at the threshold
                    # (m·w ≥ 1), within the bf16 accumulator's resolution
                    kept = torch.where(wc == w0, acc_c[key].cpu(), acc_h[key])
                    margin = kept[differ].float() * w0[differ].float()
                    assert bool((margin >= 1 - 2 ** -7).all()), (
                        arch, key, margin.min())
                    ties += int(differ.sum())
                continue
            total += w0.numel()
            d = (wc.float() - wh.float()).abs()
            far = d > TRAIN_SMOKE_FP_ATOL
            if far.any():
                moved = (wh.float() - w0.float()).abs()
                assert bool((moved[far] < 0.99 * TRAIN_SMOKE_FP_LR).all()), (
                    arch, key, float(d.max()))
                assert float(d.max()) <= 2 * TRAIN_SMOKE_FP_LR, (arch, key)
                loose += int(far.sum())
            fp_err = max(fp_err, float(d[~far].max()) if (~far).any() else 0.0)
    torch.cuda.synchronize()
    launches, routes = _counts()
    assert loose <= 0.01 * total, (arch, loose, total)
    assert flips > 0, arch
    assert all(r["tensor_cores"] == 0 for r in routes.values()), routes
    print(f"  {arch} (smoke, fp32) {steps} step(s) x 2 microbatches card vs "
          f"CPU: loss max |diff| {loss_err:.3g}; {flips} flips on the CPU, "
          f"{ties} differing decisions (all ties at the threshold); FP leaves "
          f"max |diff| {fp_err:.3g} ({loose} unsaturated Adam elements of "
          f"{total}); card launches {launches}, by route {routes}")
    return ({"loss_abs_err": loss_err, "flips": flips, "ties": ties,
             "fp_max_abs_err": fp_err, "fp_unsaturated": loose,
             "launches": launches, "routes": routes}, p_c, s_c)


def train_check(torch, seed: int):
    """Phase 6: gemma2-2b's smoke config, 3 steps card vs CPU, then a
    checkpoint of the card's params and optimizer state round-trips."""
    import tempfile

    from repro_torch.checkpoint import restore_pytree, save_pytree
    from repro_torch.checkpoint.manager import _flatten

    r, p_c, s_c = train_agree_with_cpu(torch, seed, "gemma2-2b", 3)
    tree = {"params": p_c, "opt": s_c}
    with tempfile.TemporaryDirectory() as tmp:
        save_pytree(tree, tmp, 3, sync=True)
        back, step_no = restore_pytree(_to(tree, "cuda"), tmp)
    assert step_no == 3
    flat_a, flat_b = _flatten(tree), _flatten(back)
    assert flat_a.keys() == flat_b.keys()
    for k, a in flat_a.items():
        b = flat_b[k]
        assert b.is_cuda and b.dtype == a.dtype and torch.equal(a, b), k
    print(f"  checkpoint of the card's params and optimizer state: "
          f"{len(flat_a)} leaves round-trip bit for bit")
    return {"train_smoke_loss_max_abs_err": r["loss_abs_err"],
            "train_smoke_flips": r["flips"], "train_smoke_ties": r["ties"],
            "train_smoke_fp_max_abs_err": r["fp_max_abs_err"],
            "train_smoke_fp_unsaturated": r["fp_unsaturated"],
            "train_smoke_gemv_routes": r["routes"]["packed_xnor_gemv"],
            "train_smoke_routes": r["routes"]}


# ---------------------------------------------------------------------------
# 7. prefix-cached serving of gemma2-2b at published widths
# ---------------------------------------------------------------------------
PFX_SYSTEM, PFX_REQUESTS, PFX_TOKENS, PFX_REPEATS = 512, 16, 32, (0, 3, 7, 12)


def _pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


@contextlib.contextmanager
def block_calls(force=None, rows=None):
    """Keep, in call order, each block's prefill input ``x`` and its
    attention's arguments and output while the block runs (the flash
    kernel's for a cold prefill, the prefix kernel's for a tail). With
    ``force`` (the ``x`` list of a cold run) and ``rows`` (lo, hi), teacher
    forcing: block n's input rows 0..hi-lo are replaced by rows lo..hi of
    the cold run's input to block n, so each block of the tail starts from
    exactly the cold run's layer input; the calls themselves are
    unchanged."""
    import repro_torch.models.attention as A
    import repro_torch.models.lm as LM

    block, flash = LM._apply_block_prefill, LM.flash_attention_fwd
    prefix = A.flash_prefix_attention_paged
    seen = {"x": [], "attention": []}

    def keep(fn):
        def call(*args, **kw):
            out = fn(*args, **kw)
            seen["attention"].append((args, kw, out))
            return out
        return call

    def forced(cfg, bp, role, x, positions, **kw):
        if force is not None:
            lo, hi = rows
            x = x.clone()
            x[:, :hi - lo] = force[len(seen["x"])][:, lo:hi]
        seen["x"].append(x)
        return block(cfg, bp, role, x, positions, **kw)

    LM._apply_block_prefill, LM.flash_attention_fwd = forced, keep(flash)
    A.flash_prefix_attention_paged = keep(prefix)
    try:
        yield seen
    finally:
        LM._apply_block_prefill, LM.flash_attention_fwd = block, flash
        A.flash_prefix_attention_paged = prefix


def tail_route_check(torch, eng, prompt, hit: int, page: int):
    """Every layer of a partial hit's tail prefill against the cold prefill
    of its full prompt at the same positions, under teacher forcing: both
    run through ``ServeEngine.prefill_commit`` as the session calls it, and
    each block of the tail takes the cold run's input to that block (its
    rows ``hit`` on). So each layer's difference is that layer's own: the
    K/V rows each commits to the pool and, over a bf16 pool, the attention
    output. Only the projections' summation order (the GEMV at <= 256 rows,
    the unpacked matmul above) and where each kernel rounds p to bf16
    (against its own running max) differ, so every element of every layer
    must agree within bf16 roundings; a wrong offset, page, prefix length or
    mask in the tail route moves whole rows. Under kv-quant the tail attends
    over the prefix rows dequantised from the pool, so the cold attention
    is recomputed over those same rows (its own rows from the tail on).
    Returns the readings by layer; fails past a tolerance at any layer."""
    import numpy as np
    import repro_torch.models.lm as LM
    from repro_torch.kernels.paged_attention import gather_prefix_rows
    from repro_torch.serve import paged_pool_init

    cfg = eng.cfg
    assert hit % page == 0 and hit < len(prompt)
    S, T = len(prompt), len(prompt) - hit
    n_cold, n_tail = -(-S // page), -(-T // page)
    pool = paged_pool_init(cfg, 1 + n_cold + n_tail, page, eng.device)
    cold_ids = np.zeros((_pow2(S) // page,), np.int32)
    cold_ids[:n_cold] = np.arange(1, 1 + n_cold)
    tail_ids = np.zeros((_pow2(T) // page,), np.int32)
    tail_ids[:n_tail] = np.arange(1 + n_cold, 1 + n_cold + n_tail)
    prefix_ids = np.zeros((_pow2(hit // page),), np.int32)
    prefix_ids[:hit // page] = cold_ids[:hit // page]
    padded = np.zeros((_pow2(S),), np.int32)
    padded[:S] = prompt
    with block_calls() as cold:
        eng.prefill_commit(pool, padded, S, cold_ids, page)
    padded = np.zeros((_pow2(T),), np.int32)
    padded[:T] = prompt[hit:]
    with block_calls(cold["x"], (hit, S)) as tail:
        eng.prefill_commit(pool, padded, T, tail_ids, page, offset=hit,
                           prefix_ids=prefix_ids)
    n_roles = len(pool)
    n_layers = cfg.n_groups * n_roles
    assert len(cold["attention"]) == len(tail["attention"]) == n_layers

    KV, quant = cfg.kv_heads_padded(), cfg.kv_cache_quant
    hp, hd = cfg.heads_padded(), cfg.head_dim_

    def rows(name, ids, lo, hi, block, group):
        """Committed rows lo..hi of pages ``ids`` of one layer, fp32."""
        blk = pool[block]
        idx = torch.from_numpy(ids).to(eng.device)
        scale = blk[f"{name}_scale"][group] if quant else None
        r = gather_prefix_rows(blk[name][group], idx, scale)[lo:hi]
        step = 0.0
        if quant:                       # one int8 step of each row
            step = scale.index_select(0, idx.long()).reshape(-1, KV)[lo:hi,
                                                                     :, None]
        return r, step

    def compare(a, b, tol):
        diff = (a - b).abs()
        return {"max_abs_err": diff.max().item(),
                "max_err_over_tol": (diff / tol).max().item(),
                "share_not_equal": (diff > 0).float().mean().item()}

    out = {"k": [], "v": [], "attention": []}
    for n in range(n_layers):
        g, blk = divmod(n, n_roles)
        blk = f"b{blk}"
        for name in ("k", "v"):
            a, step_a = rows(name, tail_ids[:n_tail], 0, T, blk, g)  # the tail's
            b, step_b = rows(name, cold_ids[:n_cold], hit, S, blk, g)  # cold's
            # a last-bit difference of a projection sum, carried through
            # RoPE (which mixes each pair d, d + hd/2) and the bf16
            # rounding; under kv-quant it may move a code by one step of
            # the row's scale
            mag = torch.maximum(a.abs(), b.abs())
            if name == "k":
                mag = mag + mag.roll(hd // 2, dims=-1)
            tol = 2.0 ** -6 * mag + 1e-6
            if quant:
                tol = tol + torch.maximum(step_a, step_b)
            out[name].append(compare(a, b, tol))
        (qc, kc, vc), kw, out_c = cold["attention"][n]
        if quant:   # the cold prefill over the prefix rows the tail reads
            kc, vc = kc.clone(), vc.clone()
            for name, x in (("k", kc), ("v", vc)):
                r, _ = rows(name, cold_ids[:n_cold], 0, hit, blk, g)
                x[:, :hit] = r.transpose(0, 1).to(x.dtype)
            out_c = LM.flash_attention_fwd(qc, kc, vc, **kw)
        absv = LM.flash_attention_fwd(qc, kc, vc.abs(), **kw)
        b, absv = (x.reshape(hp, -1, hd)[:, hit:S].float()
                   for x in (out_c, absv))
        a = tail["attention"][n][2][0, :T].transpose(0, 1).float()
        # p one bf16 rounding apart and the scores moved by the
        # projections' last bits: 2^-7 of sum p|v| / l; then both outputs
        # rounded to bf16, each by up to 2^-8 of the value
        tol = 2.0 ** -7 * (absv + torch.maximum(a.abs(), b.abs())) + 1e-6
        out["attention"].append(compare(a, b, tol))
    for what, by_layer in out.items():
        worst = max(range(n_layers),
                    key=lambda n: by_layer[n]["max_err_over_tol"])
        r = by_layer[worst]
        print(f"    {what} of the {T}-row tail at offset {hit} vs the cold "
              f"prefill, each of {n_layers} layers teacher-forced: worst layer "
              f"{worst}, max_abs_err {r['max_abs_err']:.3g}, max err/tol "
              f"{r['max_err_over_tol']:.3g}, share not bit-equal "
              f"{r['share_not_equal']:.3g}; max err/tol by layer "
              + " ".join(f"{x['max_err_over_tol']:.2g}" for x in by_layer))
    bad = {(w, n): r for w, by_layer in out.items()
           for n, r in enumerate(by_layer) if not r["max_err_over_tol"] <= 1.0}
    assert not bad, f"tail route disagrees with the cold prefill: {bad}"
    return out


def serve_prefix(torch, engine, seed: int):
    import numpy as np
    from repro_torch.serve import ServeEngine

    cfg = engine.cfg
    V = cfg.vocab_size
    rng = np.random.default_rng(seed + 7)
    system = rng.integers(0, V, (PFX_SYSTEM,)).astype(np.int32)
    tail_lens = rng.integers(16, 257, (PFX_REQUESTS,))
    prompts = [np.concatenate([system, rng.integers(0, V, (n,)).astype(np.int32)])
               for n in tail_lens]
    out = {}
    for quant in (False, True):
        label = "kv-quant" if quant else "bf16"
        eng = engine if not quant else ServeEngine(
            cfg.scaled(kv_cache_quant=True), engine.params, max_len=1024,
            packed=True)
        gc_collect(torch)
        torch.cuda.reset_peak_memory_stats()
        res = prefix_traffic(torch, eng, prompts, PFX_REPEATS, PFX_TOKENS,
                             lanes=8, page=16, segment=8)
        peak = torch.cuda.max_memory_allocated()
        st, launches = res["stats"], res["launches"]
        want_kinds = expected_kinds(PFX_REQUESTS, PFX_REPEATS, quant)
        assert res["kinds"] == want_kinds, (res["kinds"], want_kinds)
        n_exact = want_kinds.count("exact")
        n_partial = want_kinds.count("partial")
        pstats = st["prefix"]
        assert (pstats["exact_hits"], pstats["partial_hits"], pstats["misses"]) \
            == (n_exact, n_partial, 1), pstats
        assert (st["exact_admits"], st["prefills"], st["tail_prefills"]) \
            == (n_exact, 1, n_partial), st
        L = cfg.n_layers
        # the projections of a prefill of <= 256 rows take the GEMV
        gemv_prefills = sum(c for b, c in st["buckets"].items() if int(b) <= 256)
        want = {"packed_xnor_gemv": 4 * L * (st["decode_steps"] + gemv_prefills),
                "paged_flash_decode": L * st["decode_steps"],
                "boolean_weight_bwd": 0,
                "flash_attention_fwd": L * st["prefills"],
                "paged_prefix_attention": L * st["tail_prefills"],
                "boolean_matmul": 0, "packed_xnor_matmul": 0}
        print(f"  {label}: kinds {dict((k, want_kinds.count(k)) for k in ('cold', 'partial', 'exact'))}, "
              f"prefix stats {pstats}")
        print(f"  {label}: launches {launches}, expected {want}")
        assert launches == want, (launches, want)
        print(f"  {label}: launches by route {res['routes']}")
        for name in ("packed_xnor_gemv", "flash_attention_fwd",
                     "paged_prefix_attention", "paged_flash_decode"):
            assert res["routes"][name] == {"tensor_cores": want[name],
                                           "cuda_cores": 0}, \
                (label, name, res["routes"][name])
        for name in ("paged_flash_decode", "flash_attention_fwd",
                     "paged_prefix_attention"):
            assert launches[name] > 0, launches
        rr = res["repeat_round_launches"]
        n_rep_partial = sum(k == "partial" for k in want_kinds[PFX_REQUESTS:])
        assert rr["flash_attention_fwd"] == 0 and \
            rr["paged_prefix_attention"] == L * n_rep_partial, rr
        streams = res["streams"]
        exact_same = []
        for j, i in enumerate(PFX_REPEATS):
            s_rep = streams[PFX_REQUESTS + j]
            if want_kinds[PFX_REQUESTS + j] == "exact":
                assert s_rep == streams[i], (label, i, s_rep, streams[i])
                exact_same.append(i)
        print(f"  {label}: exact-hit streams bit-identical to the streams that "
              f"seeded their records: prompts {exact_same}")

        # read, not checked: each partial-hit stream against a cold run of
        # its full prompt. At published widths with random weights a
        # rounding-level change decorrelates the logits within the model's
        # layers, so where a stream first diverges says nothing of the tail
        # route; tail_route_check holds each layer instead.
        cold = eng.generate_batch(prompts, PFX_TOKENS, lanes=8, page_size=16,
                                  segment=8, prefix_cache=False)
        agree = []
        for i in range(1, PFX_REQUESTS):
            a, b = streams[i], cold[i].tolist()
            agree.append(next((t for t, (x, y) in enumerate(zip(a, b))
                               if x != y), len(b)))
        print(f"  {label}: partial-hit tokens agreeing with a cold run before "
              f"the first divergence: {agree} (of {PFX_TOKENS} each)")
        # the longest tail: its bucket takes the GEMV, the cold one does not
        i = max(range(1, PFX_REQUESTS), key=lambda j: len(prompts[j]))
        route = tail_route_check(torch, eng, prompts[i], PFX_SYSTEM, 16)

        ttft = {k: statistics.median(v) for k, v in res["ttft_ms"].items()}
        admit = {k: statistics.median(v) for k, v in res["admit_ms"].items()}
        step = statistics.median(res["step_ms"])
        print(f"  {label}: TTFT median (admission work alone) cold "
              f"{ttft['cold']:.1f} ({admit['cold']:.1f}) ms, partial "
              f"{ttft['partial']:.1f} ({admit['partial']:.1f}) ms, exact "
              f"{ttft['exact']:.1f} ({admit['exact']:.1f}) ms; decode step "
              f"median {step:.2f} ms; max_memory_allocated "
              f"{peak / 2**30:.2f} GiB")
        out[label] = {"kinds": want_kinds, "stats": st, "launches": launches,
                      "repeat_round_launches": rr, "ttft_ms_median": ttft,
                      "admit_ms_median": admit, "ttft_ms": res["ttft_ms"],
                      "admit_ms": res["admit_ms"], "step_ms_median": step,
                      "max_memory_allocated_bytes": peak,
                      "routes": res["routes"],
                      "partial_agreement": agree,
                      "tail_route": route,
                      "exact_identical": exact_same, "audit": res["audit"]}
        if quant:
            del eng
    return out


# ---------------------------------------------------------------------------
# 8. Boolean VGG-SMALL and SMALL-EDSR at published widths
# ---------------------------------------------------------------------------
VGG_BATCH, VGG_BATCHES, VGG_TRAIN_STEPS = 100, 10, 3
EDSR_BLOCKS, EDSR_WIDTH, EDSR_SCALE, EDSR_BATCH, EDSR_HW = 8, 64, 2, 4, 128
LEAF_FORMS = ("float", "int8", "packed")


@contextlib.contextmanager
def plain_kernels():
    """While the block runs, the inference convs call the two GEMM kernels'
    plain versions (on the card) instead of their wrappers, whose counters
    therefore do not move."""
    import repro_torch.core.boolean_conv as BC
    from repro_torch.kernels import boolean_matmul_plain, packed_xnor_matmul_plain

    saved = BC.boolean_matmul, BC.packed_xnor_matmul
    BC.boolean_matmul = boolean_matmul_plain
    BC.packed_xnor_matmul = packed_xnor_matmul_plain
    try:
        yield
    finally:
        BC.boolean_matmul, BC.packed_xnor_matmul = saved


def leaf_form(torch, w, form):
    """A Boolean leaf as a float ±1 view, int8, or PackedBool."""
    from repro_torch.core import pack_boolean_weight

    if form == "float":
        return w.to(torch.float32)
    return w if form == "int8" else pack_boolean_weight(w)


def vgg_leaves(torch, params, form):
    return {k: ({c: {**l, "w": leaf_form(torch, l["w"], form)}
                 for c, l in v.items()} if k.startswith("s") else v)
            for k, v in params.items()}


def counted(torch, fn, want_kernel, n_launches):
    """Run ``fn`` with the launch counters zeroed just before and read just
    after; every kernel but ``want_kernel`` must stay at 0 and that one must
    reach ``n_launches``. Returns (result, launches, seconds)."""
    from repro_torch.kernels import KERNELS

    torch.cuda.synchronize()
    for k in KERNELS:
        k.launches = 0
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t
    launches = {k.__name__: k.launches for k in KERNELS}
    want = {k.__name__: 0 for k in KERNELS}
    if want_kernel is not None:
        want[want_kernel] = n_launches
    assert launches == want, (launches, want)
    return out, launches, dt


def vgg_routes(torch, cfg, params, batches, label):
    """Each leaf form over the batches (launches counted, images/s); the
    kernel routes against the plain route and each other; the float route's
    differences counted."""
    from repro_torch.vision import vgg_forward

    n_pm1 = sum(n for _, n in cfg.stages) - 2      # ±1-input Boolean convs
    kernel_of = {"float": None, "int8": "boolean_matmul",
                 "packed": "packed_xnor_matmul"}
    runs, out = {}, {"images": len(batches) * batches[0].shape[0]}
    with torch.no_grad():
        for form in LEAF_FORMS:
            p = vgg_leaves(torch, params, form)
            vgg_forward(p, cfg, batches[0])                  # warm-up
            res, launches, dt = counted(
                torch, lambda: [vgg_forward(p, cfg, x) for x in batches],
                kernel_of[form], n_pm1 * len(batches))
            runs[form] = res
            out[form] = {"launches": launches, "seconds": dt,
                         "images_per_s": out["images"] / dt}
            if form != "float":
                with plain_kernels():
                    plain = [vgg_forward(p, cfg, x) for x in batches]
                torch.cuda.synchronize()
                for (lg, acts), (lg_p, acts_p) in zip(res, plain):
                    assert all(torch.equal(a, b) for a, b in zip(acts, acts_p)), \
                        f"{label} {form}: ±1 activations differ from the plain route"
                    assert torch.equal(lg.argmax(-1), lg_p.argmax(-1))
                out[form]["logits_max_abs_diff_vs_plain"] = max(
                    (lg - lg_p).abs().max().item()
                    for (lg, _), (lg_p, _) in zip(res, plain))
    n_acts = n_pm1 + 1
    for (lg8, a8), (lgp, ap) in zip(runs["int8"], runs["packed"]):
        assert len(a8) == len(ap) == n_acts
        assert all(torch.equal(a, b) for a, b in zip(a8, ap)), \
            f"{label}: int8 and packed routes' ±1 activations differ"
        assert torch.equal(lg8.argmax(-1), lgp.argmax(-1))
        assert tuple(lg8.shape) == (batches[0].shape[0], cfg.n_classes)
        assert bool(torch.isfinite(lg8).all())
    diff = [0] * n_acts
    pred_diff, logit_diff = 0, 0.0
    for (lgf, af), (lg8, a8) in zip(runs["float"], runs["int8"]):
        for i, (a, b) in enumerate(zip(af, a8)):
            diff[i] += int((a.to(torch.int8) != b).sum())
        pred_diff += int((lgf.argmax(-1) != lg8.argmax(-1)).sum())
        logit_diff = max(logit_diff, (lgf - lg8).abs().max().item())
    total = [sum(a[i].numel() for _, a in runs["int8"]) for i in range(n_acts)]
    out["float_route"] = {"differing_activations_by_layer": diff,
                          "activations_by_layer": total,
                          "differing_predictions": pred_diff,
                          "logits_max_abs_diff_vs_int8": logit_diff}
    print(f"  {label}: kernel routes' ±1 activations identical to the plain "
          f"route and to each other in all {n_acts} Boolean layers of "
          f"{len(batches)} batches; predictions identical")
    print(f"  {label}: float route (cuDNN fp32) differs from the int8 route in "
          f"{diff} of {total} activations by layer, {pred_diff} of "
          f"{out['images']} predictions, logits by up to {logit_diff:.3g}")
    for form in LEAF_FORMS:
        r = out[form]
        print(f"  {label} {form}: {r['images_per_s']:.0f} images/s "
              f"({r['seconds'] * 1e3 / len(batches):.2f} ms a batch of "
              f"{batches[0].shape[0]}), launches {r['launches']}")
    return out


def vision(torch, seed: int):
    from repro_torch.configs import get_config
    from repro_torch.core.optimizer import adam, boolean_optimizer, tree_leaves
    from repro_torch.examples import finetune_boolean_cnn as example
    from repro_torch.vision import edsr_apply, edsr_init, vgg_init

    gc_collect(torch)
    cfg = get_config("bold-vgg-small")
    print(f"  VGG-SMALL stages {cfg.stages}, fc {cfg.fc_dim}, "
          f"{cfg.input_hw}x{cfg.input_hw}x{cfg.in_channels}, {cfg.n_classes} "
          f"classes; {VGG_BATCHES} batches of {VGG_BATCH}")
    gen = torch.Generator(device="cuda").manual_seed(seed + 8)
    xs, ys = example.synthetic_task(gen, VGG_BATCH * VGG_BATCHES,
                                    cfg.input_hw, cfg.n_classes)
    batches, labels = list(xs.split(VGG_BATCH)), list(ys.split(VGG_BATCH))
    out = {}
    for bn in (False, True):
        c = cfg.scaled(with_bn=bn)
        params = vgg_init(c, torch.Generator(device="cuda").manual_seed(seed))
        out["vgg_bn" if bn else "vgg"] = vgg_routes(
            torch, c, params, batches, "VGG-SMALL" + (" with BN" if bn else ""))

    # training: the example's step (flip rule + Adam) at batch 100
    gc_collect(torch)
    params = vgg_init(cfg, torch.Generator(device="cuda").manual_seed(seed))
    bool_t, fp_t = example.split_params(params)
    bopt, fopt = boolean_optimizer(6.0), adam(2e-3)
    bstate, fstate = bopt.init(bool_t), fopt.init(fp_t)
    torch.cuda.reset_peak_memory_stats()
    steps = []
    for i in range(VGG_TRAIN_STEPS):
        j = i % len(batches)
        (loss, acc, _), launches, dt = counted(torch, lambda: example.train_step(
            cfg, bopt, fopt, bool_t, fp_t, bstate, fstate, batches[j],
            labels[j]), None, 0)
        steps.append({"ms": dt * 1e3, "loss": float(loss), "acc": float(acc),
                      "flips": sum(float(f) for f in tree_leaves(bstate.flips))})
    peak = torch.cuda.max_memory_allocated()
    assert all(math.isfinite(s["loss"]) for s in steps), steps
    assert all(bool(((w == 1) | (w == -1)).all()) for w in tree_leaves(bool_t))
    out["vgg_train"] = {"steps": steps, "max_memory_allocated_bytes": peak}
    print("  VGG-SMALL training (example step, flip rule + Adam, batch "
          f"{VGG_BATCH}): " + ", ".join(
              f"{s['ms']:.1f} ms loss {s['loss']:.4f} flips {s['flips']:.0f}"
              for s in steps) + f"; max_memory_allocated {peak / 2**30:.2f} GiB")

    # SMALL-EDSR through the int8 and packed routes
    gc_collect(torch)
    gen = torch.Generator(device="cuda").manual_seed(seed + 9)
    params = edsr_init(gen, EDSR_BLOCKS, EDSR_WIDTH, EDSR_SCALE)
    x = torch.rand((EDSR_BATCH, EDSR_HW, EDSR_HW, 3), generator=gen,
                   device="cuda")

    def blocks(form):
        return {k: ({j: leaf_form(torch, w, form) for j, w in v.items()}
                    if k.startswith("b") else v) for k, v in params.items()}

    kernel_of = {"float": None, "int8": "boolean_matmul",
                 "packed": "packed_xnor_matmul"}
    edsr, ys_ = {}, {}
    with torch.no_grad():
        for form in LEAF_FORMS:
            p = blocks(form)
            edsr_apply(p, x, EDSR_BLOCKS, EDSR_SCALE)               # warm-up
            y, launches, dt = counted(
                torch, lambda: edsr_apply(p, x, EDSR_BLOCKS, EDSR_SCALE),
                kernel_of[form], EDSR_BLOCKS)
            assert tuple(y.shape) == (EDSR_BATCH, EDSR_HW * EDSR_SCALE,
                                      EDSR_HW * EDSR_SCALE, 3), y.shape
            assert bool(torch.isfinite(y).all())
            ys_[form] = y
            edsr[form] = {"launches": launches, "ms": dt * 1e3,
                          "images_per_s": EDSR_BATCH / dt}
            if form != "float":
                with plain_kernels():
                    y_plain = edsr_apply(p, x, EDSR_BLOCKS, EDSR_SCALE)
                assert torch.equal(y, y_plain), f"EDSR {form}: differs from plain"
    assert torch.equal(ys_["int8"], ys_["packed"])
    edsr["float_route_max_abs_diff_vs_int8"] = \
        (ys_["float"] - ys_["int8"]).abs().max().item()
    out["edsr"] = edsr
    print(f"  SMALL-EDSR ({EDSR_BLOCKS} blocks, width {EDSR_WIDTH}, x{EDSR_SCALE}) "
          f"on {EDSR_BATCH} x {EDSR_HW}x{EDSR_HW}: int8 and packed routes "
          f"identical to the plain route and to each other; float route within "
          f"{edsr['float_route_max_abs_diff_vs_int8']:.3g}")
    for form in LEAF_FORMS:
        r = edsr[form]
        print(f"  SMALL-EDSR {form}: {r['ms']:.2f} ms a forward "
              f"({r['images_per_s']:.1f} images/s), launches {r['launches']}")
    return out

# ---------------------------------------------------------------------------
# 9. qwen2.5-14b at published widths: greedy and sampled traffic
# ---------------------------------------------------------------------------
QWEN_LENS = (16, 40, 100, 200, 250, 600, 300, 20, 64, 130, 500, 33, 256, 90,
             480, 17)                    # phase 3's prompt lengths
QWEN_TOKENS, QWEN_TEMP, QWEN_FIRST_WAVE, QWEN_CANCEL = 32, 0.8, 10, 3
QWEN_ROUTE_PROMPT = 400                  # decode_route_check: > 256 rows, so
                                         # the plain forward's projections
                                         # are dense matmuls, no kernel


def qwen_sampling(i: int, seed: int, n_tok: int = QWEN_TOKENS):
    """Request i's SamplingParams in phase 9: i % 4 of 0 or 1 greedy, 2 at
    T = 0.8 with its own seed, 3 at T = 0.8 on the session key folded with
    its request id (8 greedy, 4 seeded, 4 session-keyed of 16)."""
    from repro_torch.serve import SamplingParams

    if i % 4 < 2:
        return SamplingParams(max_tokens=n_tok)
    return SamplingParams(max_tokens=n_tok, temperature=QWEN_TEMP,
                          seed=seed + 1000 + i if i % 4 == 2 else None)


def timed_segments(torch, engine, prompts, skey, params_for,
                   n_tok: int = QWEN_TOKENS):
    """The first 8 requests (``params_for(i)``: request i's SamplingParams)
    admitted untimed, then each decode segment timed between synchronizes
    until the lanes drain -> (ms a step for each segment, decode tokens,
    decode seconds)."""
    seg_ms, decode_tokens, decode_s = [], 0, 0.0
    sess = engine.session(lanes=8, page_size=16, segment=8, key=skey)
    for i in range(8):
        sess.submit(prompts[i], params_for(i))
    while sess.step():
        if not sess.sched.pending and all(
                len(r.emitted) for r in sess.sched.active.values()):
            break
    while not sess.idle:
        before = sum(len(r.emitted) for r in sess.sched.active.values())
        lanes_live = len(sess.sched.active)
        torch.cuda.synchronize()
        t = time.perf_counter()
        sess.step()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        seg_ms.append(dt * 1e3 / sess.segment)
        decode_tokens += min(lanes_live * sess.segment,
                             lanes_live * n_tok - before)
        decode_s += dt
    sess.close()
    return seg_ms, decode_tokens, decode_s


def launch_us(torch, n: int = 20000) -> float:
    """Host microseconds a launch of a one-element in-place add, over a
    loop of ``n`` ended by a synchronize: the floor under every eager op of
    a serving step."""
    x = torch.zeros(1, device="cuda")
    for _ in range(200):
        x.add_(1)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(n):
        x.add_(1)
    torch.cuda.synchronize()
    return (time.perf_counter() - t) / n * 1e6


def step_probe(torch, seed: int):
    """``--step-probe``: phase 9's decode step (``timed_segments``, the
    same engine and traffic) and the host cost of one launch, read in turn
    in one process: fresh, fresh again, after a torch.profiler session (as
    phases 3, 5, 7 and 9 hold one), after CPU matmuls on the default
    threads (as phases 4 and 6 run CPU engines), and with the garbage
    collector off. Which reading moves says what sets the step."""
    import gc

    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.models import lm_init
    from repro_torch.serve import PRNGKey, ServeEngine, pack_weights

    build.build_all()
    cfg = get_config("qwen2.5-14b")
    params = lm_init(cfg, torch.Generator(device="cuda").manual_seed(seed))
    engine = ServeEngine(cfg, pack_weights(params, consume=True),
                         max_len=1024, packed=True)
    del params
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab_size, (n,)).astype(np.int32)
               for n in QWEN_LENS]
    skey = PRNGKey(seed + 9)
    readings = []

    def read(label):
        seg_ms, toks, secs = timed_segments(
            torch, engine, prompts, skey, lambda i: qwen_sampling(i, seed))
        r = {"after": label, "launch_us": launch_us(torch),
             "step_ms_median": statistics.median(seg_ms),
             "tokens_per_s": toks / secs, "step_ms": seg_ms}
        print(f"  {label}: one launch {r['launch_us']:.2f} us of host, "
              f"decode step median {r['step_ms_median']:.2f} ms, "
              f"{r['tokens_per_s']:.1f} tokens/s")
        readings.append(r)

    for i in range(3):
        read(f"fresh, reading {i + 1}")
    _profiled(torch, lambda: torch.ones(8, device="cuda").sum())
    for i in range(2):
        read(f"a torch.profiler session, reading {i + 1}")
    a = torch.randn(1024, 1024)
    t = time.perf_counter()
    while time.perf_counter() - t < 2.0:
        a = torch.tanh(a @ a)
    read(f"2 s of CPU matmuls on {torch.get_num_threads()} threads")
    gc.disable()
    try:
        read("the garbage collector off")
    finally:
        gc.enable()
    return readings


@contextlib.contextmanager
def decode_group_sizes():
    """Count the decode kernel's launches by (route, group size R), from
    the launches the wrapper makes (paged_attention._decode_launch)."""
    import collections

    import repro_torch.kernels.paged_attention as PA

    launch, sizes = PA._decode_launch, collections.Counter()

    def counted(route, q, *args, **kw):
        sizes[(route, q.shape[2])] += 1
        return launch(route, q, *args, **kw)

    PA._decode_launch = counted
    try:
        yield sizes
    finally:
        PA._decode_launch = launch


@contextlib.contextmanager
def recorded_draws(limit: int = 16):
    """Keep the first ``limit`` sampled draws of the sessions' decode
    segments on the card (``ServeEngine.decode_segment`` draws them): the
    logits, temperatures, keys and steps each was given and the tokens it
    returned."""
    import repro_torch.serve.engine as SE

    draw, seen = SE.sample_tokens, []

    def keep(cfg, logits, temperature=0.0, key=None, step=0):
        out = draw(cfg, logits, temperature, key, step)
        if key is not None and hasattr(temperature, "clone") \
                and len(seen) < limit:
            seen.append(tuple(t.clone() for t in
                              (logits, temperature, key, step, out)))
        return out

    SE.sample_tokens = keep
    try:
        yield seen
    finally:
        SE.sample_tokens = draw


def sampling_card_vs_cpu(torch, cfg, keys, draws):
    """The port's random stream on the card against the CPU: the bits of a
    (rows, vocab) draw for every key of ``keys`` folded with steps 0, 1, 7,
    8 and 31, bit for bit; and every recorded decode-segment draw of
    ``draws`` redone on the CPU from the same logits copied to the host:
    tokens identical except near-ties, which are counted, as are the rows
    whose top-2 gap is that close whether or not their tokens differ. Both
    sides draw from the same logits, so a score (logits / T + Gumbel)
    differs only by the ulps of the two libraries' log and the fp32 sum:
    each of the top-2 scores is held within eps = 2^-20 of 1 + |g| + |z|
    of the CPU's, and a differing token must score within 2 eps of the
    CPU's winner, a fixed bound."""
    import numpy as np
    from repro_torch.serve.sampling import (fold_in, gumbel, random_bits,
                                            sample_tokens)

    V = cfg.vocab_size
    steps = np.asarray([0, 1, 7, 8, 31], np.int64)
    ks = np.repeat(np.asarray(keys, np.uint32), len(steps), axis=0)
    st = np.tile(steps, len(keys))
    bits = [random_bits(fold_in(ks, st, dev), (len(ks), V), dev).cpu()
            for dev in ("cuda", "cpu")]
    same_bits = bool(torch.equal(bits[0], bits[1]))
    print(f"  threefry bits card vs CPU: {len(ks)} (key, step) draws of "
          f"{V} words, bit-identical {same_bits}")
    assert same_bits, "the card's random bits differ from the CPU's"

    rows = mismatched = near = 0
    for logits, temps, kk, ss, out in draws:
        args = [t.cpu() for t in (logits, temps, kk, ss)]
        cpu = sample_tokens(cfg, *args[:1], *args[1:])
        hot = args[1] > 0
        rows += int(hot.sum())
        z, g = [], None
        for dev, lg in (("cuda", logits), ("cpu", args[0])):
            sc = lg[..., :V].float() / torch.clamp(
                temps.to(dev).float(), min=1e-6)[:, None]
            g = gumbel(fold_in(kk.to(dev), ss.to(dev), dev),
                       tuple(sc.shape), dev).cpu()
            z.append(sc.cpu() + g)
        eps = 2.0 ** -20 * (1.0 + g.abs().amax(-1) + z[1].abs().amax(-1))
        top = torch.topk(z[1], 2, dim=-1).indices
        pick = lambda t: torch.gather(t, 1, top)
        off = (pick(z[0]) - pick(z[1])).abs().amax(-1)
        assert not bool((hot & (off > eps)).any()), \
            ("card and CPU scores differ beyond the log's ulps",
             off[hot].max(), eps[hot].min())
        gap = pick(z[1])[:, 0] - pick(z[1])[:, 1]
        tie = hot & (gap <= 2 * eps)
        card = out.cpu()[:, :1].long()
        under = z[1].gather(1, top[:, :1]) - z[1].gather(1, card)
        differ = card[:, 0] != cpu[:, 0]
        near += int(tie.sum())
        mismatched += int(differ.sum())
        assert not bool((differ & ~(hot & (under[:, 0] <= 2 * eps))).any()), \
            ("card and CPU sampling differ beyond a near-tie",
             under[differ, 0], eps[differ])
    print(f"  sample_tokens card vs CPU over {len(draws)} recorded segment "
          f"draws ({rows} sampled rows): {mismatched} tokens differ, "
          f"{near} near-ties (all differences near-ties)")

    # the cost of one step's draw at 8 lanes: sampled (per-lane streams)
    # and greedy, device time by CUDA events and host time a call
    logits, temps, kk, ss, _ = draws[0]
    cost = {}
    for label, args in (("sampled", (temps, kk, ss)), ("greedy", ())):
        def draw():
            return sample_tokens(cfg, logits, *args)
        flush = torch.empty(1 << 20, dtype=torch.uint8, device="cuda")
        cost[f"{label}_ms"] = time_ms(torch, draw, flush)
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(20):
            draw()
        cost[f"{label}_host_us"] = (time.perf_counter() - t) / 20 * 1e6
        torch.cuda.synchronize()
    print(f"  one step's draw at {logits.shape[0]} lanes over {V} tokens: "
          f"sampled {cost['sampled_ms']:.3f} ms on the card, "
          f"{cost['sampled_host_us']:.0f} us of host a call; greedy "
          f"{cost['greedy_ms']:.3f} ms, {cost['greedy_host_us']:.0f} us")
    return {"bits_identical": same_bits, "draws": len(draws),
            "sampled_rows": rows, "tokens_differing": mismatched,
            "near_ties": near, "draw_cost": cost}


def decode_route_check(torch, eng, prompt, token: int, page: int = 16):
    """One decode step of one lane through the paged path (the GEMV and
    the decode kernel) against the plain full forward (``lm_forward``:
    dense matmuls for its > 256 rows, the chunked plain attention) over the
    prompt and ``token``, on the card, every layer teacher-forced: the pool
    holds the forward's own K/V rows of the prompt, and each block of the
    decode step takes the forward's input to that block at the decode
    position. So each layer's difference is that layer's own. At each of
    the layers:

    * the new K/V rows against the forward's row at the position: the
      projections' summation order (the GEMV's against cuBLAS's) may move
      a bf16 rounding of q, k or v, carried through the scale, the bias,
      RoPE (which mixes d with d + hd/2) and the bf16 rounding: 2^-6 of the
      larger magnitude (of both RoPE partners for k), as tail_route_check;
    * the attention output against the forward's: the forward rounds p to
      bf16 before its value product and its output to bf16, and q, k carry
      the roundings above: 2^-7 of sum p|v| / l and of the larger output;
    * the attention output against the exact attention (fp64) over the
      decode's own operands (its q, the pool rows it read, its new row):
      2^-16 of sum p|v| / l plus 2^-24 of the value, about ten times the
      fp32 sums' error measured in phase 2; the check asserts that the
      kernel's output rounded to fp16, or to int8 at a scale of its
      largest value, would fail it.

    Returns the readings by layer; fails past a tolerance at any layer."""
    import numpy as np
    import repro_torch.models.attention as A
    import repro_torch.models.lm as LM
    from repro_torch.kernels import packed_xnor_gemv, paged_flash_decode
    from repro_torch.models import lm_forward
    from repro_torch.serve import commit_prefill, paged_pool_init

    cfg = eng.cfg
    S = len(prompt)
    hp, kvp, hd = cfg.heads_padded(), cfg.kv_heads_padded(), cfg.head_dim_
    R = hp // kvp
    n_layers = cfg.n_groups
    assert len(LM.block_roles(cfg)) == 1 and S + 1 > 256
    qkv, attn, x_in = A._qkv, A.flash_attention, LM._apply_block
    seen = {"x": [], "qkv": [], "attention": []}

    def keep_qkv(*args, **kw):
        out = qkv(*args, **kw)
        seen["qkv"].append(out)
        return out

    def keep_attn(*args, **kw):
        out = attn(*args, **kw)
        seen["attention"].append(out)
        return out

    def keep_x(cfg_, bp, role, x, positions):
        seen["x"].append(x)
        return x_in(cfg_, bp, role, x, positions)

    # the plain full forward over prompt + token
    tokens = torch.from_numpy(np.append(prompt, token).astype(np.int32)[None])
    A._qkv, A.flash_attention, LM._apply_block = keep_qkv, keep_attn, keep_x
    try:
        with torch.no_grad():
            lm_forward(cfg.scaled(remat=False), eng.params,
                       {"tokens": tokens.to(eng.device)})
    finally:
        A._qkv, A.flash_attention, LM._apply_block = qkv, attn, x_in
    ref = {k: list(v) for k, v in seen.items()}
    assert all(len(v) == n_layers for v in ref.values()), \
        {k: len(v) for k, v in ref.items()}

    # the pool: the forward's K/V rows 0..S-1, in pages 1..C of one lane
    C = -(-(S + 1) // page)
    pool = paged_pool_init(cfg, 1 + C, page, eng.device)
    ids = torch.arange(1, 1 + C, dtype=torch.int32)
    rows = {n: torch.stack([r[i][:, :S] for r in ref["qkv"]])
            for i, n in ((1, "k"), (2, "v"))}
    commit_prefill(cfg, pool, {"b0": rows}, ids, page, length=S)
    del rows

    # one paged decode step of that lane at position S, teacher-forced
    dec = {"x": 0, "qkv": [], "out": []}
    block_dec, decode = LM._apply_block_decode, A.paged_flash_decode

    def forced(cfg_, bp, role, bcache, x, pos, block_table, *route):
        x = ref["x"][dec["x"]][:, S:S + 1].clone()
        dec["x"] += 1
        return block_dec(cfg_, bp, role, bcache, x, pos, block_table, *route)

    def keep_decode(*args, **kw):
        out = decode(*args, **kw)
        dec["out"].append(out)
        return out

    def keep_qkv_dec(*args, **kw):
        out = qkv(*args, **kw)
        dec["qkv"].append(out)
        return out

    cache = {"blocks": pool, "block_table": ids[None].to(eng.device),
             "pos": torch.tensor([S], dtype=torch.int32, device=eng.device)}
    zero_counts()
    LM._apply_block_decode, A.paged_flash_decode = forced, keep_decode
    A._qkv = keep_qkv_dec
    try:
        with torch.no_grad():
            eng.decode_step(cache, torch.tensor([[token]], dtype=torch.int32,
                                                device=eng.device))
    finally:
        LM._apply_block_decode, A.paged_flash_decode = block_dec, decode
        A._qkv = qkv
    torch.cuda.synchronize()
    assert dec["x"] == len(dec["out"]) == n_layers
    assert paged_flash_decode.tc_launches == n_layers \
        and packed_xnor_gemv.tc_launches == 6 * n_layers, route_counts()

    def compare(a, b, tol):
        diff = (a - b).abs()
        return {"max_abs_err": diff.max().item(),
                "max_err_over_tol": (diff / tol).max().item(),
                "share_not_equal": (diff > 0).float().mean().item()}

    def fails(a, b, tol):
        return bool(((a - b).abs() > tol).any())

    out = {"k": [], "v": [], "attention": [], "attention_exact": []}
    col, off = S // page, S % page
    teeth = {"fp16": 0, "int8": 0}
    for n in range(n_layers):
        for i, name in ((1, "k"), (2, "v")):
            a = pool["b0"][name][n, col + 1, off].float()   # page ids[col]
            b = ref["qkv"][n][i][0, S].float()
            mag = torch.maximum(a.abs(), b.abs())
            if name == "k":
                mag = mag + mag.roll(hd // 2, dims=-1)
            out[name].append(compare(a, b, 2.0 ** -6 * mag + 1e-6))
        # the exact attention over the decode's own operands, in fp64
        q = dec["qkv"][n][0][0, 0].double().reshape(kvp, R, hd)
        k = pool["b0"]["k"][n, 1:1 + C].reshape(-1, kvp, hd)[:S + 1].double()
        v = pool["b0"]["v"][n, 1:1 + C].reshape(-1, kvp, hd)[:S + 1].double()
        p = torch.softmax(torch.einsum("grd,cgd->grc", q, k) / math.sqrt(hd),
                          dim=-1)
        exact = torch.einsum("grc,cgd->grd", p, v)
        absv = torch.einsum("grc,cgd->grd", p, v.abs())
        got = dec["out"][n].double()[0]                   # (KV, R, hd)
        tol = 2.0 ** -16 * absv + 2.0 ** -24 * exact.abs()
        out["attention_exact"].append(compare(got, exact, tol))
        teeth["fp16"] += fails(got.half().double(), exact, tol)
        scale = got.abs().max() / 127
        teeth["int8"] += fails(torch.round(got / scale) * scale, exact, tol)
        # against the forward's attention output at S
        b = ref["attention"][n][0, S].double().reshape(kvp, R, hd)
        tol = 2.0 ** -7 * (absv + torch.maximum(got.abs(), b.abs())) + 1e-6
        out["attention"].append(compare(got, b, tol))
    for what, by_layer in out.items():
        worst = max(range(n_layers),
                    key=lambda n: by_layer[n]["max_err_over_tol"])
        r = by_layer[worst]
        print(f"    decode {what} at position {S}, each of {n_layers} layers "
              f"teacher-forced: worst layer {worst}, max_abs_err "
              f"{r['max_abs_err']:.3g}, max err/tol "
              f"{r['max_err_over_tol']:.3g}, share not bit-equal "
              f"{r['share_not_equal']:.3g}; max err/tol by layer "
              + " ".join(f"{x['max_err_over_tol']:.2g}" for x in by_layer))
    print(f"    the exact-attention tolerance fails the kernel's output "
          f"rounded to fp16 at {teeth['fp16']} and to int8 at "
          f"{teeth['int8']} of {n_layers} layers")
    bad = {(w, n): r for w, by_layer in out.items()
           for n, r in enumerate(by_layer) if not r["max_err_over_tol"] <= 1.0}
    assert not bad, f"decode route disagrees with the plain forward: {bad}"
    assert teeth["fp16"] > 0 and teeth["int8"] > 0, teeth
    out["teeth"] = teeth
    return out


def serve_qwen(torch, seed: int):
    """Phase 9: qwen2.5-14b at its published widths (48 layers, d_model
    5120, vocab 152064, bf16), packed, through ServeEngine.session with
    greedy and sampled requests; launch counts exact, every launch on the
    tensor-core route, the decode at R = 6; init + pack peak memory under
    80 GB; decode_route_check; card sampling against the CPU's."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.kernels import KERNELS
    from repro_torch.models import lm_init
    from repro_torch.serve import (PRNGKey, RequestStatus, ServeEngine,
                                   pack_weights)
    from repro_torch.serve.sampling import fold_in

    cfg = get_config("qwen2.5-14b")
    gc_collect(torch)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = lm_init(cfg, gen)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    engine = ServeEngine(cfg, pack_weights(params, consume=True), max_len=1024,
                         packed=True)
    del params
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    setup_peak = torch.cuda.max_memory_allocated()
    resident = torch.cuda.memory_allocated()
    card = smi_line()
    print(f"  qwen2.5-14b {cfg.n_layers} layers d_model {cfg.d_model} vocab "
          f"{cfg.vocab_size} {cfg.dtype}: init {init_s:.1f} s, init + pack "
          f"{setup_s:.1f} s, peak memory of init + pack "
          f"{setup_peak / 1e9:.2f} GB ({base / 1e9:.2f} GB held before), "
          f"resident after {resident / 1e9:.2f} GB ({card})")
    assert setup_peak < 80e9, f"init + pack peaked at {setup_peak} bytes"

    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab_size, (n,)).astype(np.int32)
               for n in QWEN_LENS]
    skey = PRNGKey(seed + 9)
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    submitted, first_at, handles = {}, {}, []
    with decode_group_sizes() as sizes, recorded_draws() as draws:
        sess = engine.session(lanes=8, page_size=16, segment=8, key=skey)

        def submit(i):
            submitted[i] = time.perf_counter()
            handles.append(sess.submit(prompts[i], qwen_sampling(i, seed)))

        for i in range(QWEN_FIRST_WAVE):
            submit(i)
        steps = 0
        t_serve = time.perf_counter()
        while sess.step():
            steps += 1
            now = time.perf_counter()
            for h in handles:
                if h.rid not in first_at and h.tokens_ready:
                    first_at[h.rid] = now
            if steps == 2:
                for i in range(QWEN_FIRST_WAVE, len(prompts)):
                    submit(i)
            if steps == 3:
                assert handles[QWEN_CANCEL].cancel()
        torch.cuda.synchronize()
        serve_s = time.perf_counter() - t_serve
    launches = {k.__name__: k.launches for k in KERNELS}
    routes = route_counts()
    peak = torch.cuda.max_memory_allocated()
    stats = sess.work
    d_steps = stats["decode_steps"]
    gemv_prefills = sum(c for b, c in stats["prefills"].items() if b <= 256)
    want = {"packed_xnor_gemv": 6 * cfg.n_layers * (d_steps + gemv_prefills),
            "paged_flash_decode": cfg.n_layers * d_steps,
            "boolean_weight_bwd": 0,
            "flash_attention_fwd": cfg.n_layers * sum(stats["prefills"].values()),
            "paged_prefix_attention": 0, "boolean_matmul": 0,
            "packed_xnor_matmul": 0}
    print(f"  served {len(handles)} requests (8 greedy, 4 seeded and 4 "
          f"session-keyed at T = {QWEN_TEMP}) in {serve_s:.2f} s: {d_steps} "
          f"decode steps, prefill buckets {dict(stats['prefills'])}")
    print(f"  launches {launches}, expected {want} (6 x {cfg.n_layers} GEMV "
          f"per decode step and per prefill of <= 256 rows, {cfg.n_layers} "
          f"paged decode per decode step, {cfg.n_layers} flash prefill per "
          "prefill)")
    assert launches == want, (launches, want)
    print(f"  launches by route {routes}; decode launches by (route, R) "
          f"{dict(sizes)}")
    for name in ("packed_xnor_gemv", "flash_attention_fwd", "paged_flash_decode"):
        assert want[name] > 0 and routes[name] == {
            "tensor_cores": want[name], "cuda_cores": 0}, (name, routes[name])
    assert dict(sizes) == {("tensor_cores", 6): want["paged_flash_decode"]}, sizes
    for i, h in enumerate(handles):
        toks = h.tokens_so_far()
        assert all(0 <= t < cfg.vocab_size for t in toks), h.rid
        if h.rid == QWEN_CANCEL:
            assert h.status is RequestStatus.CANCELLED and len(toks) < QWEN_TOKENS
        else:
            assert h.status is RequestStatus.DONE \
                and len(toks) == QWEN_TOKENS, (h.rid, h.status, len(toks))
    assert draws, "no sampled decode segment was recorded"
    ttft = [1e3 * (first_at[r] - submitted[r]) for r in first_at]

    # the same traffic again, timed per segment, for the step and token rates
    seg_ms, decode_tokens, decode_s = timed_segments(
        torch, engine, prompts, skey, lambda i: qwen_sampling(i, seed))
    host_launch_us = launch_us(torch)
    profile = profile_segment(torch, engine, prompts[:8], QWEN_TOKENS,
                              lambda i: qwen_sampling(i, seed), skey)

    keys = [PRNGKey(seed + 1000 + i) if i % 4 == 2
            else fold_in(skey, i).numpy().astype(np.uint32)
            for i in range(len(prompts)) if i % 4 >= 2]
    sampling = sampling_card_vs_cpu(torch, cfg, keys, draws)
    del draws

    print(f"  decode_route_check: one lane's decode step at position "
          f"{QWEN_ROUTE_PROMPT} against the plain forward, teacher-forced")
    route_check = decode_route_check(
        torch, engine, rng.integers(0, cfg.vocab_size, (QWEN_ROUTE_PROMPT,)
                                    ).astype(np.int32),
        int(rng.integers(0, cfg.vocab_size)))
    metrics = {
        "model": cfg.name, "requests": len(handles), "decode_steps": d_steps,
        "prefill_buckets": {str(b): c for b, c in stats["prefills"].items()},
        "serve_s": serve_s, "init_s": init_s, "setup_s": setup_s,
        "setup_peak_bytes": setup_peak, "resident_bytes": resident,
        "ttft_ms_median": statistics.median(ttft), "ttft_ms_max": max(ttft),
        "step_ms_median": statistics.median(seg_ms),
        "decode_tokens_per_s": decode_tokens / decode_s,
        "launch_us": host_launch_us,
        "max_memory_allocated_bytes": peak,
        "launches": launches, "routes": routes,
        "decode_group_sizes": {f"{r} R{n}": c for (r, n), c in sizes.items()},
        "profiled_segment": profile, "sampling": sampling,
        "decode_route_check": route_check,
    }
    print(f"  decode {metrics['decode_tokens_per_s']:.1f} tokens/s at 8 lanes, "
          f"median step {metrics['step_ms_median']:.2f} ms (one launch "
          f"{host_launch_us:.2f} us of host), median TTFT "
          f"{metrics['ttft_ms_median']:.1f} ms, max_memory_allocated "
          f"{peak / 1e9:.2f} GB while serving ({card})")
    metrics["device"] = card
    return engine, metrics


# ---------------------------------------------------------------------------
# 10. falcon-mamba-7b at published widths
# ---------------------------------------------------------------------------
# falcon-mamba-7b's five packed projections a block: (name, K, N); x_proj's
# N = 288 leaves a partial 32-column tile of the tensor-core route, dt_proj's
# K = 256 is 8 words (two 4-word stages)
MAMBA_GEMV_SHAPES = (("in_x", 4096, 8192), ("in_z", 4096, 8192),
                     ("x_proj", 8192, 288), ("dt_proj", 256, 8192),
                     ("out_proj", 8192, 4096))
MAMBA_TOKENS = 32
# phase 10 serves the first 32 of falcon-mamba-7b's 64 blocks at published
# widths: the depth is cut to keep the whole script well inside its time
FALCON_LAYERS = 32
MAMBA_KERNEL_GROUPS = (("packed_xnor_gemv", ("xnor_gemv",)),
                       ("gemm (head; projections of > 256 rows, cuBLAS)",
                        ("gemm", "sm90_", "cutlass", "nvjet")))
MAMBA_REST = "elementwise (selective scan, conv, norms, unpack)"
# ssm_state_check: a prefill of <= 256 rows (the GEMV) and one past it (the
# unpacked matmul). Tolerances relative to the layer's max |state|. h: the
# prefill and the decode round dt to bf16 apart (2^-8) and dt enters
# exp(dt·A) with |A| up to 16, so decay's relative error reaches
# 16·dt·2^-8 = 2^-4 at dt near 1; conv: the rows of x alone, a bf16
# rounding (2^-8) with room for two
MAMBA_STATE_PROMPTS = (100, 300)
MAMBA_STATE_TOL = {"h": 2.0 ** -4, "conv": 2.0 ** -6}
MAMBA_PFX_SYSTEM, MAMBA_PFX_REQUESTS, MAMBA_PFX_REPEATS = 512, 8, (0, 2, 4, 6)


def _rel(got, ref):
    """max |got - ref| over max |ref|."""
    return ((got.float() - ref.float()).abs().max()
            / ref.float().abs().max().clamp_min(1e-30)).item()


def ssm_state_check(torch, eng, prompt):
    """Prefill(S) then one decode step against prefill(S + 1), layer by
    layer and teacher-forced: the input to each mamba block of a prefill of
    ``prompt`` (S + 1 tokens) is kept, and at every layer the block runs
    over its first S rows (return_state), then ``mamba_decode`` on row S
    from that state; its h and conv must equal the block's state over all
    S + 1 rows within MAMBA_STATE_TOL of the layer's max |state|. Returns
    the ratio to the tolerance by layer."""
    import repro_torch.models.mamba as M
    from repro_torch.models import lm_prefill
    from repro_torch.models.lm import index_tree

    cfg = eng.cfg
    S = len(prompt) - 1
    xs, apply = [], M.mamba_apply

    def keep(cfg_, p, x, **kw):
        xs.append(x)
        return apply(cfg_, p, x, **kw)

    M.mamba_apply = keep
    try:
        with torch.no_grad():
            lm_prefill(cfg, eng.params, {"tokens": torch.from_numpy(
                prompt[None]).to(eng.device)})
    finally:
        M.mamba_apply = apply
    assert len(xs) == cfg.n_layers, len(xs)
    ratios = {"h": [], "conv": []}
    with torch.no_grad():
        for g, x in enumerate(xs):
            p = index_tree(eng.params["blocks"]["b0"]["mamba"], g)
            _, (h1, c1) = apply(cfg, p, x, return_state=True)
            _, (h0, c0) = apply(cfg, p, x[:, :S], return_state=True)
            _, new = M.mamba_decode(cfg, p, x[:, S:S + 1],
                                    {"h": h0, "conv": c0.float()})
            ratios["h"].append(_rel(new["h"], h1) / MAMBA_STATE_TOL["h"])
            ratios["conv"].append(_rel(new["conv"], c1)
                                  / MAMBA_STATE_TOL["conv"])
    worst = {k: max(v) for k, v in ratios.items()}
    print(f"  ssm_state_check S={S} ({'GEMV' if S + 1 <= 256 else 'unpacked'}"
          f" prefill rows): worst layer at {worst['h']:.3f} (h) and "
          f"{worst['conv']:.3f} (conv) of the tolerance {MAMBA_STATE_TOL} "
          f"x max |state|; by layer h {[round(r, 3) for r in ratios['h']]}")
    assert max(worst.values()) <= 1.0, worst
    return {"S": S, "tol": MAMBA_STATE_TOL, "worst": worst,
            "by_layer": ratios}


def _prefill_snaps(torch, eng, tokens, bucket: int, page: int, **tail):
    """The page-boundary snapshots of a prefill of ``tokens`` right-padded
    to ``bucket``, as the session runs it (``tail``: offset, ssm_init)."""
    import numpy as np
    from repro_torch.models import lm_prefill

    padded = np.zeros((bucket,), np.int32)
    padded[:len(tokens)] = tokens
    if tail:       # an attention-free tail: no prefix pages to read
        tail.update(prefix_len=tail["offset"], prefix_pages={},
                    prefix_ids=torch.zeros(1, dtype=torch.int32,
                                           device=eng.device))
    with torch.no_grad():
        return lm_prefill(eng.cfg, eng.params, {"tokens": torch.from_numpy(
            padded[None]).to(eng.device)}, length=len(tokens),
            state_at=tuple(range(page, bucket + 1, page)), **tail)[2]


def snapshot_check(torch, eng, index, prompts, hit: int, page: int):
    """Every page-boundary snapshot the prefix index holds against the state
    of the prefill that stored it, rerun as the session ran it, bit for bit
    at every layer: request 0's cold prefill (its bucket, its length) for
    the shared pages and its own, and each partial hit's tail prefill (at
    offset ``hit``, resumed from the cold run's state there) for its tail
    pages. At published widths with random weights the other prefills'
    states part chaotically from these (a bf16 rounding grows through 64
    blocks), so the numerics of resuming are held by ``tail_state_check``,
    teacher-forced. Returns the count."""
    import numpy as np
    from repro_torch.serve.session import _default_bucket

    def at(snaps, idx):
        return {bi: {k: t[:, :, idx] for k, t in leaves.items()}
                for bi, leaves in snaps.items()}

    cold = _prefill_snaps(torch, eng, prompts[0],
                          _default_bucket(len(prompts[0])), page)
    n_hit = hit // page
    tails = {}

    def stored_by(owner, k):
        """The snapshots of the prefill that stored page k, and its index."""
        if owner == 0 or k < n_hit:
            return cold, k
        if owner not in tails:
            T = len(prompts[owner]) - hit
            tails[owner] = _prefill_snaps(
                torch, eng, prompts[owner][hit:], _default_bucket(T), page,
                offset=hit, ssm_init=at(cold, n_hit - 1))
        return tails[owner], k - n_hit

    stack, count = [(index.root, 0)], 0
    while stack:
        node, depth = stack.pop()
        stack.extend((c, depth + len(node.pages)) for c in node.children.values())
        if node is index.root:
            continue
        path = np.concatenate([n.key for n in index._chain(node)])
        owner = next(i for i, p in enumerate(prompts)
                     if np.array_equal(p[:len(path)], path))
        for j, snap in enumerate(node.snaps):
            want = at(*stored_by(owner, depth + j))
            for bi, leaves in snap.items():
                for name, t in leaves.items():
                    assert torch.equal(t, want[bi][name]), \
                        (owner, depth + j, bi, name)
            count += 1
    print(f"  snapshot check: {count} stored page-boundary snapshots x "
          f"{eng.cfg.n_layers} layers bit-identical to a rerun of the "
          "prefill that stored each")
    assert count > 0
    return count


def tail_state_check(torch, eng, prompt, hit: int, page: int):
    """A partial hit's tail prefill resumed from the boundary state, layer
    by layer and teacher-forced: the input to each mamba block of a cold
    prefill of ``prompt`` is kept; at every layer the block runs over all
    rows (the cold states at every page boundary, ``state_at``) and over
    the rows from ``hit`` on, resumed from the cold state at ``hit`` (h0,
    conv0), as the session's tail prefill does; the tail's snapshots and
    end state must equal the cold ones within MAMBA_STATE_TOL of the
    layer's max |state|. Returns the worst ratio to the tolerance."""
    import repro_torch.models.mamba as M
    from repro_torch.models import lm_prefill
    from repro_torch.models.lm import index_tree

    cfg = eng.cfg
    S = len(prompt)
    xs, apply = [], M.mamba_apply

    def keep(cfg_, p, x, **kw):
        xs.append(x)
        return apply(cfg_, p, x, **kw)

    M.mamba_apply = keep
    try:
        with torch.no_grad():
            lm_prefill(cfg, eng.params, {"tokens": torch.from_numpy(
                prompt[None]).to(eng.device)})
    finally:
        M.mamba_apply = apply
    bounds = tuple(range(page, S + 1, page))
    k0 = hit // page - 1
    worst = {"h": 0.0, "conv": 0.0}
    with torch.no_grad():
        for g, x in enumerate(xs):
            p = index_tree(eng.params["blocks"]["b0"]["mamba"], g)
            _, end, ref = apply(cfg, p, x, return_state=True, state_at=bounds)
            _, tend, tail = apply(
                cfg, p, x[:, hit:], h0=ref["h"][:, k0],
                conv0=ref["conv"][:, k0].float(), return_state=True,
                state_at=tuple(b - hit for b in bounds if b > hit))
            pairs = [(tail[k], ref[k][:, k0 + 1:]) for k in ("h", "conv")]
            pairs += [(tend[0], end[0]), (tend[1], end[1])]
            for (got, want), name in zip(pairs, ("h", "conv", "h", "conv")):
                worst[name] = max(worst[name],
                                  _rel(got, want) / MAMBA_STATE_TOL[name])
    print(f"  tail_state_check: a {S - hit}-token tail resumed at {hit}, "
          f"{len(bounds) - k0 - 1} boundaries x {len(xs)} layers, teacher-"
          f"forced: worst at {worst['h']:.3f} (h) and {worst['conv']:.3f} "
          f"(conv) of the tolerance {MAMBA_STATE_TOL} x max |state|")
    assert len(xs) == cfg.n_layers and max(worst.values()) <= 1.0, worst
    return worst


def falcon_prefix(torch, eng, seed: int):
    """The prefix round of phase 10 on the same engine: a 512-token shared
    prompt, 8 requests (distinct tails of 16..64 tokens; the first cold,
    the rest partial hits resuming the recurrence from the snapshot at
    512), then 4 exact repeats."""
    import numpy as np

    cfg = eng.cfg
    V, L = cfg.vocab_size, cfg.n_layers
    rng = np.random.default_rng(seed + 11)
    system = rng.integers(0, V, (MAMBA_PFX_SYSTEM,)).astype(np.int32)
    prompts = [np.concatenate([system, rng.integers(0, V, (n,)).astype(np.int32)])
               for n in rng.integers(16, 65, (MAMBA_PFX_REQUESTS,))]
    res = prefix_traffic(torch, eng, prompts, MAMBA_PFX_REPEATS, MAMBA_TOKENS,
                         lanes=8, page=16, segment=8)
    want_kinds = expected_kinds(MAMBA_PFX_REQUESTS, MAMBA_PFX_REPEATS, False)
    assert res["kinds"] == want_kinds, (res["kinds"], want_kinds)
    st, launches = res["stats"], res["launches"]
    n_exact = want_kinds.count("exact")
    assert (st["exact_admits"], st["prefills"], st["tail_prefills"]) \
        == (n_exact, 1, MAMBA_PFX_REQUESTS - 1), st
    gemv_prefills = sum(c for b, c in st["buckets"].items() if int(b) <= 256)
    want = {k: 0 for k in launches}
    want["packed_xnor_gemv"] = 5 * L * (st["decode_steps"] + gemv_prefills)
    print(f"  prefix round: kinds {want_kinds}, prefix stats {st['prefix']}; "
          f"launches {launches}, expected {want}")
    assert launches == want, (launches, want)
    assert res["routes"]["packed_xnor_gemv"] == {
        "tensor_cores": want["packed_xnor_gemv"], "cuda_cores": 0}
    assert res["repeat_round_launches"]["packed_xnor_gemv"] == 0
    streams = res["streams"]
    for j, i in enumerate(MAMBA_PFX_REPEATS):
        assert streams[MAMBA_PFX_REQUESTS + j] == streams[i], (i, j)
    print(f"  exact-hit streams bit-identical to the streams that seeded "
          f"their records: prompts {list(MAMBA_PFX_REPEATS)} (prompt 0's "
          "its cold run)")
    # read, not checked (phase 7's reason): partial hits against cold runs
    cold = eng.generate_batch(prompts, MAMBA_TOKENS, lanes=8, page_size=16,
                              segment=8, prefix_cache=False)
    assert cold[0].tolist() == streams[0]
    agree = [next((t for t, (x, y) in enumerate(zip(streams[i], cold[i].tolist()))
                   if x != y), MAMBA_TOKENS)
             for i in range(1, MAMBA_PFX_REQUESTS)]
    print(f"  partial-hit tokens agreeing with a cold run before the first "
          f"divergence: {agree} (of {MAMBA_TOKENS} each)")
    snaps = snapshot_check(torch, eng, res["index"], prompts,
                           MAMBA_PFX_SYSTEM, 16)
    i = max(range(1, MAMBA_PFX_REQUESTS), key=lambda j: len(prompts[j]))
    tail = tail_state_check(torch, eng, prompts[i], MAMBA_PFX_SYSTEM, 16)
    ttft = {k: statistics.median(v) for k, v in res["ttft_ms"].items()}
    admit = {k: statistics.median(v) for k, v in res["admit_ms"].items()}
    print(f"  TTFT median (admission work alone) cold {ttft['cold']:.1f} "
          f"({admit['cold']:.1f}) ms, partial {ttft['partial']:.1f} "
          f"({admit['partial']:.1f}) ms, exact {ttft['exact']:.1f} "
          f"({admit['exact']:.1f}) ms")
    return {"kinds": want_kinds, "stats": st, "launches": launches,
            "partial_agreement": agree, "snapshots": snaps,
            "tail_state_check": tail,
            "ttft_ms_median": ttft, "admit_ms_median": admit,
            "step_ms_median": statistics.median(res["step_ms"])}


def serve_falcon(torch, seed: int):
    """Phase 10: falcon-mamba-7b at its published widths, the first
    FALCON_LAYERS of its 64 mamba blocks (d_model 4096, d_inner 8192, state
    16, conv 4, dt_rank 256, vocab 65024, bf16), packed, through
    ServeEngine.session: 8 lanes, greedy, 16 requests of phase 3's prompt
    lengths, 32 tokens each, some submitted mid-flight. Launch counts exact
    (5 x L GEMV a decode step and a prefill of <= 256 rows, every one on
    the tensor-core route, no other kernel); decode step, tokens/s, TTFT,
    memory and one profiled 8-step segment; ssm_state_check; the prefix
    round."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.kernels import KERNELS
    from repro_torch.models import lm_init
    from repro_torch.serve import RequestStatus, SamplingParams, ServeEngine, pack_weights

    cfg = get_config("falcon-mamba-7b").scaled(n_layers=FALCON_LAYERS)
    L = cfg.n_layers
    gc_collect(torch)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    params = lm_init(cfg, torch.Generator(device="cuda").manual_seed(seed + 10))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    engine = ServeEngine(cfg, pack_weights(params, consume=True), max_len=1024,
                         packed=True)
    del params
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    setup_peak = torch.cuda.max_memory_allocated()
    resident = torch.cuda.memory_allocated()
    card = smi_line()
    print(f"  falcon-mamba-7b {L} layers d_model {cfg.d_model} d_inner "
          f"{cfg.d_inner_} state {cfg.ssm_state} vocab {cfg.vocab_size} "
          f"{cfg.dtype}: init {init_s:.1f} s, init + pack {setup_s:.1f} s, "
          f"peak memory of init + pack {setup_peak / 1e9:.2f} GB "
          f"({base / 1e9:.2f} GB held before), resident after "
          f"{resident / 1e9:.2f} GB ({card})")
    assert setup_peak < 80e9, f"init + pack peaked at {setup_peak} bytes"

    rng = np.random.default_rng(seed + 10)
    prompts = [rng.integers(0, cfg.vocab_size, (n,)).astype(np.int32)
               for n in QWEN_LENS]
    greedy = SamplingParams(max_tokens=MAMBA_TOKENS)
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    submitted, first_at, handles = {}, {}, []
    sess = engine.session(lanes=8, page_size=16, segment=8)

    def submit(i):
        submitted[i] = time.perf_counter()
        handles.append(sess.submit(prompts[i], greedy))

    for i in range(QWEN_FIRST_WAVE):
        submit(i)
    steps = 0
    t_serve = time.perf_counter()
    while sess.step():
        steps += 1
        now = time.perf_counter()
        for h in handles:
            if h.rid not in first_at and h.tokens_ready:
                first_at[h.rid] = now
        if steps == 2:
            for i in range(QWEN_FIRST_WAVE, len(prompts)):
                submit(i)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t_serve
    launches = {k.__name__: k.launches for k in KERNELS}
    routes = route_counts()
    peak = torch.cuda.max_memory_allocated()
    stats = sess.work
    d_steps = stats["decode_steps"]
    gemv_prefills = sum(c for b, c in stats["prefills"].items() if b <= 256)
    want = {k: 0 for k in launches}
    want["packed_xnor_gemv"] = 5 * L * (d_steps + gemv_prefills)
    print(f"  served {len(handles)} greedy requests in {serve_s:.2f} s: "
          f"{d_steps} decode steps, prefill buckets {dict(stats['prefills'])}")
    print(f"  launches {launches}, expected {want} (5 x {L} GEMV per decode "
          "step and per prefill of <= 256 rows)")
    assert launches == want, (launches, want)
    print(f"  GEMV launches by route {routes['packed_xnor_gemv']}")
    assert routes["packed_xnor_gemv"] == {"tensor_cores": want["packed_xnor_gemv"],
                                          "cuda_cores": 0}, routes
    for h in handles:
        toks = h.tokens_so_far()
        assert h.status is RequestStatus.DONE and len(toks) == MAMBA_TOKENS \
            and all(0 <= t < cfg.vocab_size for t in toks), (h.rid, h.status)
    ttft = [1e3 * (first_at[r] - submitted[r]) for r in first_at]
    sess.close()

    seg_ms, decode_tokens, decode_s = timed_segments(
        torch, engine, prompts, None, lambda i: greedy, MAMBA_TOKENS)
    host_launch_us = launch_us(torch)
    profile = profile_segment(torch, engine, prompts[:8], MAMBA_TOKENS,
                              kernel_groups=MAMBA_KERNEL_GROUPS,
                              rest=MAMBA_REST)
    state = [ssm_state_check(torch, engine, rng.integers(
        0, cfg.vocab_size, (n + 1,)).astype(np.int32))
        for n in MAMBA_STATE_PROMPTS]
    prefix = falcon_prefix(torch, engine, seed)
    metrics = {
        "model": cfg.name, "requests": len(handles), "decode_steps": d_steps,
        "prefill_buckets": {str(b): c for b, c in stats["prefills"].items()},
        "serve_s": serve_s, "init_s": init_s, "setup_s": setup_s,
        "setup_peak_bytes": setup_peak, "resident_bytes": resident,
        "ttft_ms_median": statistics.median(ttft), "ttft_ms_max": max(ttft),
        "step_ms_median": statistics.median(seg_ms),
        "decode_tokens_per_s": decode_tokens / decode_s,
        "launch_us": host_launch_us, "max_memory_allocated_bytes": peak,
        "launches": launches, "routes": routes, "profiled_segment": profile,
        "ssm_state_check": state, "prefix": prefix, "device": card}
    print(f"  decode {metrics['decode_tokens_per_s']:.1f} tokens/s at 8 lanes, "
          f"median step {metrics['step_ms_median']:.2f} ms (one launch "
          f"{host_launch_us:.2f} us of host), TTFT median "
          f"{metrics['ttft_ms_median']:.1f} ms max {metrics['ttft_ms_max']:.1f} "
          f"ms, max_memory_allocated {peak / 1e9:.2f} GB while serving ({card})")
    return engine, metrics


# ---------------------------------------------------------------------------
# 11. the other families at smoke widths: card (kernels) vs CPU
# ---------------------------------------------------------------------------
FAMILY_SMOKE = ("moonshot-v1-16b-a3b", "arctic-480b", "jamba-1.5-large-398b")
EMBED_SMOKE = ("musicgen-medium", "internvl2-26b")


def _packed_per_forward(params) -> int:
    """The GEMV launches of one forward over the blocks: every packed leaf
    of every group is applied once."""
    from repro_torch.core import PackedBool

    def count(t):
        if isinstance(t, dict):
            return sum(count(v) for v in t.values())
        return t.bits.shape[0] if isinstance(t, PackedBool) else 0

    return count(params["blocks"])


def family_launches(cfg, params, decode_steps: int, buckets, n_prefills: int,
                    n_tails: int):
    """Launches a card session of ``cfg`` must make (all on the CUDA-core
    routes at fp32): the GEMV per packed leaf for every decode step and
    every prefill (cold or tail; ``buckets``: {bucket rows: count}) of <=
    256 rows, and per attention layer the paged decode every step, the
    flash prefill every cold prefill, the prefix attention every tail
    prefill."""
    from repro_torch.models import block_roles

    n_attn = cfg.n_groups * sum(r["mixer"] != "mamba" for r in block_roles(cfg))
    gemv_fwd = decode_steps + sum(c for b, c in buckets.items() if int(b) <= 256)
    return {"packed_xnor_gemv": _packed_per_forward(params) * gemv_fwd,
            "paged_flash_decode": n_attn * decode_steps,
            "flash_attention_fwd": n_attn * n_prefills,
            "paged_prefix_attention": n_attn * n_tails}


def ssm_swap_check(torch, cfg, params, prompts, mixed, lane_draw):
    """A hybrid (attention + mamba) session with the host swap tier, on the
    card and on the CPU: request 0 is preempted after 4 tokens, its page
    bytes and its lanes' mamba (h, conv) state captured to host, and
    swap-resumed. The captured state equals the lane's state at the
    preemption bit for bit, and is back in the resumed lane bit for bit;
    the streams agree card vs CPU (phase 4's near-tie rule), and on each
    device the preempted stream is read against the same request served
    without preemption."""
    from repro_torch.serve import ServeEngine

    outs, plain, state = [], [], {}
    for d in ("cuda", "cpu"):
        eng = ServeEngine(cfg, params, max_len=128, packed=True, device=d)
        with eng.session(lanes=2, page_size=16, segment=2, audit=True,
                         host_page_budget=32) as s:
            hs = [s.submit(p, mixed(i)) for i, p in enumerate(prompts)]
            while hs[0].tokens_ready < 4:
                s.step()
            req, lane = hs[0]._req, hs[0]._req.lane
            mamba = s.swap_mgr._mamba
            before = {(bi, n): s._pool[bi][n][:, lane].cpu()
                      for bi in mamba for n in s._pool[bi]}
            assert s.preempt(hs[0])
            rec = req.swap
            assert rec is not None and mamba, "no swap capture"
            for (bi, n), t in before.items():
                assert torch.equal(rec.ssm[bi][n], t), ("captured", d, bi, n)
            while req.lane < 0:
                s.step()
            for (bi, n), t in before.items():
                assert torch.equal(s._pool[bi][n][:, req.lane].cpu(), t), \
                    ("restored", d, bi, n)
            s.run_until_idle()
            assert req.preempt_swap == 1 and req.preempt_recompute == 0
            outs.append([h.tokens_so_far() for h in hs])
        with eng.session(lanes=2, page_size=16, segment=2) as s:
            hs = [s.submit(p, mixed(i)) for i, p in enumerate(prompts)]
            s.run_until_idle()
            plain.append([h.tokens_so_far() for h in hs])
        state[d] = len(before)
    engines = [ServeEngine(cfg, params, max_len=128, packed=True, device=d)
               for d in ("cuda", "cpu")]
    same, ties = streams_agree(torch, engines, outs, prompts, lane_draw)
    uninterrupted = [o == p for o, p in zip(outs, plain)]
    print(f"  {cfg.name} swap: request 0 preempted after 4 tokens and "
          f"swap-resumed; {state['cuda']} mamba leaves of its lane captured "
          f"and restored bit for bit on the card and the CPU; {same}/"
          f"{len(prompts)} streams identical card vs CPU, {ties} near-ties; "
          f"streams identical to the unpreempted run (card, CPU) "
          f"{uninterrupted}")
    return {"identical": same, "near_ties": ties,
            "state_leaves": state["cuda"],
            "identical_to_unpreempted": uninterrupted}

def families_agree(torch, seed: int):
    """Phase 11: moonshot-v1-16b-a3b, arctic-480b and jamba-1.5-large-398b
    at smoke widths (head_dim 64, as phase 4) in fp32, served packed and
    on int8 leaves on the card
    and on the CPU: phase 4's mixed traffic (greedy, seeded and session-
    keyed lanes, a cancel) identical card vs CPU but for counted near-ties,
    the card's launches on the CUDA-core routes exactly as the model's
    attention layers and packed leaves imply; jamba also prefix-cached;
    musicgen-medium's and internvl2-26b's lm_forward logits on embeddings,
    card vs CPU within SMOKE_LOGIT_ATOL."""
    import numpy as np
    from repro_torch.configs import get_smoke
    from repro_torch.models import lm_forward, lm_init
    from repro_torch.serve import PRNGKey, SamplingParams, ServeEngine
    from repro_torch.serve.sampling import fold_in

    skey = PRNGKey(seed + 13)

    def mixed(i):
        return SamplingParams(max_tokens=10, temperature=0.0 if i % 3 == 0
                              else 0.8, seed=seed + 200 + i if i % 3 == 1
                              else None)

    def lane_draw(i, t):
        sp = mixed(i)
        key = PRNGKey(sp.seed) if sp.seed is not None \
            else fold_in(skey, i).numpy().astype(np.uint32)
        return sp.temperature, key, t, 0, 1

    out = {}
    for arch in FAMILY_SMOKE:
        # head_dim 64: the attention kernels take head dims 64, 128, 256
        cfg = get_smoke(arch).scaled(dtype=torch.float32, head_dim=64)
        params = lm_init(cfg, torch.Generator().manual_seed(seed))
        rng = np.random.default_rng(seed + 17)
        prompts = [rng.integers(0, cfg.vocab_size, (n,)).astype(np.int32)
                   for n in (7, 30, 64, 5, 21, 50)]
        for packed in (True, False):
            label = f"{arch} {'packed' if packed else 'int8'}"
            engines = [ServeEngine(cfg, params, max_len=128, packed=packed,
                                   device=d) for d in ("cuda", "cpu")]
            outs, card_stats = [], None
            zero_counts()
            for e in engines:
                with e.session(lanes=4, page_size=16, segment=4, key=skey) as s:
                    hs = [s.submit(p, mixed(i)) for i, p in enumerate(prompts[:4])]
                    s.step()
                    s.step()
                    hs += [s.submit(p, mixed(i + 4))
                           for i, p in enumerate(prompts[4:])]
                    s.step()
                    hs[1].cancel()
                    s.run_until_idle()
                    outs.append([h.tokens_so_far() for h in hs])
                    if card_stats is None:
                        card_stats = dict(s.work)
                        routes = route_counts()
            same, ties = streams_agree(torch, engines, outs, prompts, lane_draw)
            want = family_launches(
                cfg, engines[0].params, card_stats["decode_steps"],
                card_stats["prefills"] + card_stats["tail_prefills"],
                sum(card_stats["prefills"].values()),
                sum(card_stats["tail_prefills"].values()))
            got = {k: routes[k]["cuda_cores"] for k in want}
            print(f"  {label}: {same}/{len(prompts)} streams identical card vs "
                  f"CPU, {ties} near-ties; card launches (CUDA-core routes) "
                  f"{got}, expected {want}")
            assert got == want, (label, got, want)
            assert all(r["tensor_cores"] == 0 for r in routes.values()), routes
            assert want["paged_flash_decode"] > 0 \
                and (want["packed_xnor_gemv"] > 0) == packed, want
            out[label] = {"identical": same, "near_ties": ties,
                          "launches": got}
        if cfg.family == "hybrid":           # jamba, prefix-cached
            system = rng.integers(0, cfg.vocab_size, (32,)).astype(np.int32)
            pfx_prompts = [np.concatenate([system, rng.integers(
                0, cfg.vocab_size, (n,)).astype(np.int32)])
                for n in (5, 17, 9, 30, 12, 3)]
            engines = [ServeEngine(cfg, params, max_len=128, packed=True,
                                   device=d) for d in ("cuda", "cpu")]
            res = [prefix_traffic(torch, e, pfx_prompts, (0, 2, 4), 8,
                                  lanes=4, page=16, segment=4)
                   for e in engines]
            want_kinds = expected_kinds(len(pfx_prompts), (0, 2, 4), False)
            assert res[0]["kinds"] == res[1]["kinds"] == want_kinds, \
                (res[0]["kinds"], want_kinds)
            assert res[0]["streams"] == res[1]["streams"], \
                (res[0]["streams"], res[1]["streams"])
            st = res[0]["stats"]
            want = family_launches(cfg, engines[0].params, st["decode_steps"],
                                   st["buckets"], st["prefills"],
                                   st["tail_prefills"])
            got = {k: res[0]["routes"][k]["cuda_cores"] for k in want}
            print(f"  {arch} prefix-cached: kinds {want_kinds}, streams "
                  f"identical card vs CPU, card launches (CUDA-core routes) "
                  f"{got}, expected {want}")
            assert got == want, (got, want)
            assert all(r["tensor_cores"] == 0 for r in res[0]["routes"].values())
            out[f"{arch} prefix"] = {"kinds": want_kinds, "launches": got}
            out[f"{arch} swap"] = ssm_swap_check(
                torch, cfg, params, pfx_prompts[:2], mixed, lane_draw)
    for arch in EMBED_SMOKE:
        cfg = get_smoke(arch).scaled(dtype=torch.float32)
        params = lm_init(cfg, torch.Generator().manual_seed(seed))
        emb = torch.randn((2, 40, cfg.d_model),
                          generator=torch.Generator().manual_seed(seed + 19))
        with torch.no_grad():
            lg = [lm_forward(cfg, ServeEngine(cfg, params, max_len=64,
                                              device=d).params,
                             {"embeddings": emb.to(d)})[0].cpu()
                  for d in ("cuda", "cpu")]
        err = (lg[0] - lg[1]).abs().max().item()
        print(f"  {arch}: lm_forward logits on embeddings card vs CPU "
              f"max_abs_err={err:.3g} (tol {SMOKE_LOGIT_ATOL})")
        assert err <= SMOKE_LOGIT_ATOL, (arch, err)
        out[arch] = {"logits_max_abs_err": err}
    return out


def ring_kernels(build, decode_kv: int, decode_kv_by_r=None):
    """ptxas's registers and spills for each instance of the tensor-core
    templates, with the dynamic shared memory its ring takes, which ptxas
    does not see: the wgmma + TMA skeleton (csrc/hopper_gemm.cuh's
    ring_kernel) by policy <BN, STAGES, BLOCKS[, FUSE]>, STAGES x (a 16 KB
    box set of the A operand + BN rows of 128 bytes of the B operand); the
    GEMV's kernel by lane tile, as the library reports its ring;
    packed_xnor_matmul by tile width, two stages of
    128 x 128 + BN x 128 bytes; the two attention kernels' tensor-core
    routes (csrc/attention_tc.cuh) by head dim (and int8 pool), as each
    library reports its ring; the decode kernel's tensor-core route by
    <head dim, group size, int8 pool> at ``decode_kv`` heads, or at
    ``decode_kv_by_r[R]`` for a group size R it names (its stages hold the
    int8 rows' scales of every head), as the library plans it;
    each with 1 KB of alignment slack and the barriers."""
    import re
    from repro_torch.kernels.packed_xnor import gemv_tc_tiles
    from repro_torch.kernels.paged_attention import (attention_tc_tiles,
                                                     decode_tc_plan)

    template = re.compile(r"(weight_bwd_tc|boolean_matmul_tc|xnor_gemv_tc_kernel"
                          r"|packed_xnor_matmul_tc|flash_tc|prefix_tc|decode_tc)"
                          r"I((?:L[a-z]+\d+E)+)")
    out = {}
    for name in ("boolean_weight_bwd", "boolean_matmul", "packed_xnor_gemv",
                 "packed_xnor_matmul", "flash_attention",
                 "paged_prefix_attention", "paged_flash_decode"):
        label = None
        for line in build.build_log(name).splitlines():
            if "Compiling entry function" in line:
                k = template.search(line)
                if k is None:
                    label = None
                    continue
                args = [int(a) for a in re.findall(r"L[a-z]+(\d+)E", k.group(2))]
                label = f"{k.group(1)}<{','.join(map(str, args))}>"
                extra = {}
                if k.group(1) == "xnor_gemv_tc_kernel":
                    tiles = gemv_tc_tiles()
                    smem = tiles.smem[args[0]]
                    extra = {"stages": tiles.stages[args[0]],
                             "blocks_per_sm": tiles.blocks[args[0]]}
                elif k.group(1) == "packed_xnor_matmul_tc":
                    smem = 1024 + 2 * 128 * (128 + args[0])
                elif k.group(1) in ("flash_tc", "prefix_tc"):
                    tiles = attention_tc_tiles(name)
                    smem = tiles.smem[args[0]]
                    extra = {"stages": tiles.stages[args[0]]}
                elif k.group(1) == "decode_tc":
                    kv = (decode_kv_by_r or {}).get(args[1], decode_kv)
                    plan = decode_tc_plan(*args, kv)
                    smem = plan.smem
                    extra = {"stages": plan.stages, "threads": plan.threads,
                             "kv_heads": kv}
                else:
                    bn, st = args[:2]
                    smem = 1024 + st * (16384 + 128 * bn + 16)
                out[label] = {"smem_bytes": smem, **extra}
            elif label and ("registers" in line or "spill" in line):
                out[label]["ptxas"] = (out[label].get("ptxas", "") + " "
                                       + line.split("info    :")[-1].strip()).strip()
    return out


# ---------------------------------------------------------------------------
# 12. moonshot-v1-16b-a3b at published widths
# ---------------------------------------------------------------------------
# its two packed projections a block (16 q and 16 KV heads of 128: wqkv's N
# = 3 x 2048) at M = 8 lanes, phase 2; its decode shape (R 1 over 16 KV
# heads, hd 128) and its largest prefill (1,024 rows, n_rep 1)
MOON_GEMV_SHAPES = (("wqkv", 2048, 6144), ("wo", 2048, 2048))
MOON_DECODE = ("phase 12", 16, 1, 128, 0.0, (("global", 0),))
MOON_FLASH_CASES = (("global", 1024, 0, "bf16", 128),)
MOON_TOKENS, MOON_REQUESTS = 32, 8          # phase 3's first 8 lengths
MOON_KERNEL_GROUPS = (
    ("packed_xnor_gemv", ("xnor_gemv",)),
    ("paged_flash_decode", ("paged_decode", "decode_tc")),
    ("flash_attention", ("flash_tc", "flash_fwd")),
    ("expert products (fp32 GEMMs)", ("sgemm", "f32f32", "gemm_f32",
                                      "s1688gemm", "gemmsn")),
    ("bf16 GEMMs (head, dispatch einsums, projections of > 256 rows)",
     ("gemm", "sm90_", "cutlass", "nvjet")),
    ("int8 -> fp32 widening and other copies", ("copy",)),
    ("dispatch (one_hot, cumsum, topk, softmax, scatter)",
     ("one_hot", "cumsum", "scan", "topk", "softmax", "sort", "index",
      "scatter", "gather")))
MOON_REST = "other elementwise (norms, rope, activations, sampling)"
# phase 12 serves the first 24 of moonshot's 48 layers at published widths:
# the depth is cut to keep the whole script well inside its time
MOON_LAYERS = 24
MOE_TOL = 1e-2      # relative RMS of a block output against its recompute
MOE_CHECK_LEN = 512  # the prefill width of moe_block_check and its timings


def _rel_rms(a, b) -> float:
    a, b = a.double(), b.double()
    return ((a - b).pow(2).mean().sqrt() / b.pow(2).mean().sqrt()).item()


def moe_block_check(torch, eng, prompt, layers=(0, MOON_LAYERS // 2)):
    """One MoE layer at published widths on the card, teacher-forced: each
    checked layer takes the input its MoE received in a prefill of
    ``prompt`` through the served weights. (1) The router's top-6 equals a
    float64 recompute of the fp32 router on the same input, outside
    near-ties (a gap under 2^-20 between the 6th and 7th probability); (2)
    the block output (bf16 activations, the int8 experts widened to fp32
    and summed in fp32) lies within MOE_TOL relative RMS of the same
    function with the expert products summed in float64; (3) the einsum
    and scatter dispatches agree within MOE_TOL, each timed at this
    prefill width; the whole block in fp32 activations is read beside it
    (not held: sign() flips near the threshold). The expert products of a
    decode step (64 experts at capacity 8) are timed alone, and beside
    them the same products on a bf16 ±1 operand (fp32 accumulation), the
    reading a later change would need."""
    import repro_torch.models.moe as MOE
    from repro_torch.models import lm_prefill

    cfg = eng.cfg
    seen = []
    apply = MOE.moe_apply

    def keep(c, p, x, *route):
        seen.append((p, x.detach().clone()))
        return apply(c, p, x, *route)

    MOE.moe_apply = keep
    try:
        with torch.no_grad():
            lm_prefill(cfg, eng.params, {"tokens": torch.from_numpy(
                prompt[None]).cuda()})
    finally:
        MOE.moe_apply = apply
    assert len(seen) == cfg.n_layers, len(seen)
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    out = {}
    bmm = MOE._bmm_f32
    for n in layers:
        p, x = seen[n]
        xf = x.reshape(-1, cfg.d_model)
        with torch.no_grad():
            probs = torch.softmax(xf.double() @ p["router"].double(), -1)
            _, experts, _ = MOE._route(cfg, p, xf)
            ref_top = torch.topk(probs, cfg.top_k + 1, dim=-1)
            gap = ref_top.values[:, cfg.top_k - 1] - ref_top.values[:, cfg.top_k]
            tie = gap < 2.0 ** -20
            same = (experts.sort(-1).values
                    == ref_top.indices[:, :cfg.top_k].sort(-1).values).all(-1)
            y = apply(cfg, p, x)[0]
            MOE._bmm_f32 = lambda a, w: torch.matmul(
                a.double(), w.double()).float()
            try:
                y64 = apply(cfg, p, x)[0]
            finally:
                MOE._bmm_f32 = bmm
            y32 = apply(cfg.scaled(dtype=torch.float32), p, x.float())[0]
            ysc = apply(cfg.scaled(moe_impl="scatter"), p, x)[0]
        torch.cuda.synchronize()
        r = {"tokens": xf.shape[0], "router_agree": int(same.sum()),
             "router_near_ties": int(tie.sum()),
             "router_disagree_outside_ties": int((~same & ~tie).sum()),
             "rel_rms_vs_f64_products": _rel_rms(y, y64),
             "max_abs_vs_f64_products": (y.float() - y64).abs().max().item(),
             "rel_rms_fp32_block": _rel_rms(y, y32),
             "rel_rms_scatter_vs_einsum": _rel_rms(ysc, y),
             "einsum_ms": time_ms(torch, lambda: apply(cfg, p, x), flush, 5),
             "scatter_ms": time_ms(torch, lambda: apply(
                 cfg.scaled(moe_impl="scatter"), p, x), flush, 5)}
        print(f"    moe layer {n} ({r['tokens']} tokens): router top-"
              f"{cfg.top_k} equal to the fp64 recompute on "
              f"{r['router_agree']}, near-ties {r['router_near_ties']}, "
              f"other disagreements {r['router_disagree_outside_ties']}; "
              f"output rel RMS vs fp64 products "
              f"{r['rel_rms_vs_f64_products']:.3g} (tol {MOE_TOL}, max abs "
              f"{r['max_abs_vs_f64_products']:.3g}), vs the fp32 block "
              f"{r['rel_rms_fp32_block']:.3g} (read); scatter vs einsum "
              f"{r['rel_rms_scatter_vs_einsum']:.3g} (tol {MOE_TOL}); einsum "
              f"{r['einsum_ms']:.3f} ms, scatter {r['scatter_ms']:.3f} ms")
        assert r["router_disagree_outside_ties"] == 0, r
        assert r["rel_rms_vs_f64_products"] <= MOE_TOL, r
        assert r["rel_rms_scatter_vs_einsum"] <= MOE_TOL, r
        assert bool(torch.isfinite(y).all())
        out[f"layer {n}"] = r
    p = seen[0][0]
    E, D = cfg.n_experts, cfg.d_model
    xin = torch.randn((E, 8, D), device="cuda").to(torch.bfloat16)
    wb = {k: p[k].to(torch.bfloat16) for k in ("wg", "wu", "wd")}
    ms = time_ms(torch, lambda: MOE._expert_mlp(cfg, p, xin), flush, 5)

    def bf16_products():
        g = torch.matmul(xin, wb["wg"])
        u = torch.matmul(xin, wb["wu"])
        return torch.matmul(g * u, wb["wd"])

    bf_ms = time_ms(torch, bf16_products, flush, 5)
    del wb
    w_bytes = sum(p[k].numel() for k in ("wg", "wu", "wd"))
    b_ms, b_by = bound(w_bytes + xin.numel() * 4, 2.0 * 8 * w_bytes, "bf16")
    out["decode_expert_products"] = {
        "ms_a_layer": ms, "bf16_operand_ms_a_layer": bf_ms,
        "int8_expert_bytes_a_layer": w_bytes, "bound_ms_a_layer": b_ms,
        "bound_by": b_by}
    print(f"    expert products of one decode step's layer (64 experts x "
          f"capacity 8): {ms:.3f} ms as served (int8 widened to fp32), "
          f"{bf_ms:.3f} ms on a bf16 +-1 operand (read), bound {b_ms:.3f} ms "
          f"({b_by}: the {w_bytes / 1e6:.0f} MB of int8 experts once)")
    del flush
    return out


def serve_moonshot(torch, seed: int):
    """Phase 12: moonshot-v1-16b-a3b at its published widths, the first
    MOON_LAYERS of its 48 layers (d_model 2048, 16 q / 16 KV heads of 128,
    64 experts top-6, d_ff 1408, vocab 163,840, bf16), packed (its wqkv and
    wo; the experts stay int8 and go through the plain torch products of
    models/moe.py, as the JAX package leaves them to XLA), through
    ServeEngine.session: 8 lanes, greedy, phase 3's first 8 prompt lengths,
    32 tokens each. Launch counts equal to the printed formula, every
    launch on the tensor-core routes; init + pack peak, resident memory,
    decode step, tokens/s, TTFT, device time by group for an admission
    round and an 8-step segment; moe_block_check."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.kernels import KERNELS
    from repro_torch.models import lm_init
    from repro_torch.serve import (RequestStatus, SamplingParams, ServeEngine,
                                   pack_weights)

    cfg = get_config("moonshot-v1-16b-a3b").scaled(n_layers=MOON_LAYERS)
    L = cfg.n_layers
    gc_collect(torch)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    params = lm_init(cfg, torch.Generator(device="cuda").manual_seed(seed + 12))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    engine = ServeEngine(cfg, pack_weights(params, consume=True), max_len=1024,
                         packed=True)
    del params
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    setup_peak = torch.cuda.max_memory_allocated()
    resident = torch.cuda.memory_allocated()
    card = smi_line()
    print(f"  moonshot-v1-16b-a3b {L} layers d_model {cfg.d_model} heads "
          f"{cfg.heads_padded()}/{cfg.kv_heads_padded()} x {cfg.head_dim_} "
          f"experts {cfg.n_experts} top-{cfg.top_k} d_ff {cfg.d_ff} vocab "
          f"{cfg.vocab_size} {cfg.dtype}: init {init_s:.1f} s, init + pack "
          f"{setup_s:.1f} s, peak memory of init + pack {setup_peak / 1e9:.2f} "
          f"GB ({base / 1e9:.2f} GB held before), resident after "
          f"{resident / 1e9:.2f} GB ({card})")
    assert setup_peak < 80e9, f"init + pack peaked at {setup_peak} bytes"

    rng = np.random.default_rng(seed + 12)
    prompts = [rng.integers(0, cfg.vocab_size, (n,)).astype(np.int32)
               for n in QWEN_LENS[:MOON_REQUESTS]]
    greedy = SamplingParams(max_tokens=MOON_TOKENS)
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    submitted, first_at, handles = {}, {}, []
    sess = engine.session(lanes=8, page_size=16, segment=8)
    t_serve = time.perf_counter()
    for i, p in enumerate(prompts):
        submitted[i] = time.perf_counter()
        handles.append(sess.submit(p, greedy))
    while sess.step():
        now = time.perf_counter()
        for h in handles:
            if h.rid not in first_at and h.tokens_ready:
                first_at[h.rid] = now
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t_serve
    launches = {k.__name__: k.launches for k in KERNELS}
    routes = route_counts()
    peak = torch.cuda.max_memory_allocated()
    work = sess.work
    d_steps = work["decode_steps"]
    n_prefills = sum(work["prefills"].values())
    gemv_prefills = sum(c for b, c in work["prefills"].items() if b <= 256)
    want = {k: 0 for k in launches}
    want["packed_xnor_gemv"] = 2 * L * (d_steps + gemv_prefills)
    want["paged_flash_decode"] = L * d_steps
    want["flash_attention_fwd"] = L * n_prefills
    print(f"  served {len(handles)} greedy requests in {serve_s:.2f} s: "
          f"{d_steps} decode steps, prefill buckets {dict(work['prefills'])}")
    print(f"  launches {launches}, expected {want}: GEMV 2 packed projections "
          f"x {L} layers x ({d_steps} decode steps + {gemv_prefills} prefills "
          f"of <= 256 rows), paged decode {L} x {d_steps} decode steps, flash "
          f"{L} x {n_prefills} prefills")
    assert launches == want, (launches, want)
    print(f"  launches by route {routes}")
    for name in ("packed_xnor_gemv", "paged_flash_decode", "flash_attention_fwd"):
        assert want[name] > 0 and routes[name] == {
            "tensor_cores": want[name], "cuda_cores": 0}, (name, routes[name])
    for h in handles:
        toks = h.tokens_so_far()
        assert h.status is RequestStatus.DONE and len(toks) == MOON_TOKENS \
            and all(0 <= t < cfg.vocab_size for t in toks), (h.rid, h.status)
    ttft = [1e3 * (first_at[r] - submitted[r]) for r in first_at]
    sess.close()

    seg_ms, decode_tokens, decode_s = timed_segments(
        torch, engine, prompts, None, lambda i: greedy, MOON_TOKENS)
    profile = profile_segment(torch, engine, prompts, MOON_TOKENS,
                              kernel_groups=MOON_KERNEL_GROUPS, rest=MOON_REST)
    moe = moe_block_check(torch, engine, rng.integers(
        0, cfg.vocab_size, (MOE_CHECK_LEN,)).astype(np.int32))
    metrics = {
        "model": cfg.name, "requests": len(handles), "decode_steps": d_steps,
        "prefill_buckets": {str(b): c for b, c in work["prefills"].items()},
        "serve_s": serve_s, "init_s": init_s, "setup_s": setup_s,
        "setup_peak_bytes": setup_peak, "resident_bytes": resident,
        "ttft_ms_median": statistics.median(ttft), "ttft_ms_max": max(ttft),
        "step_ms_median": statistics.median(seg_ms),
        "decode_tokens_per_s": decode_tokens / decode_s,
        "max_memory_allocated_bytes": peak, "launches": launches,
        "expected_launches": want, "routes": routes,
        "profiled_segment": profile, "moe_block_check": moe, "device": card}
    print(f"  decode {metrics['decode_tokens_per_s']:.1f} tokens/s at 8 lanes, "
          f"median step {metrics['step_ms_median']:.2f} ms, TTFT median "
          f"{metrics['ttft_ms_median']:.1f} ms max {metrics['ttft_ms_max']:.1f} "
          f"ms, max_memory_allocated {peak / 1e9:.2f} GB while serving ({card})")
    return metrics


# ---------------------------------------------------------------------------
# 13. overload, the host swap tier, faults and chaos: gemma2-2b at published
#     widths
# ---------------------------------------------------------------------------
# The traffic, fixed: 24 requests of 200 to 900 tokens, 48 tokens each, two
# tenants (even and odd request ids) under page quotas, 16 at priority 0
# (4 at once, the other 12 two a step once the high-priority ones are in)
# and 8 at priority 1 arriving together after two decode segments, three
# with deadlines on an injected clock that advances OVL_MS_A_STEP a step. The device pool holds 192 pages (three
# lanes of max_len), far below the offered load; the host tier holds
# OVL_HOST_PAGES, so the first preemptions swap and later ones recompute.
OVL_LENS = (880, 610, 420, 760, 300, 530, 900, 250, 690, 370, 820, 460, 220,
            640, 350, 780, 260, 200, 310, 240, 280, 230, 330, 210)
OVL_LOW, OVL_FIRST, OVL_PER_STEP = 16, 4, 2
OVL_TOKENS, OVL_POOL_PAGES, OVL_HOST_PAGES = 48, 193, 150
OVL_MAX_PENDING, OVL_TENANT_PAGES = 7, 200
OVL_DEADLINES = {3: 30.0, 9: 250.0, 19: 40.0}   # request id -> deadline_ms
OVL_MS_A_STEP = 10.0
# the prefix round: four repeats of a shared 512-token prompt and a partial
# hit, close(), then a session adopting the demoted index: a promoted exact
# hit and a partial hit over promoted pages
OVL_SHARED, OVL_PFX_TAILS, OVL_PFX_TOKENS, OVL_PFX_HOST = 512, (100, 37), 32, 96
# one seeded soak (bf16 pool): FaultSchedule.random(0, DEFAULT_RATES,
# horizon=64) over 12 requests, the swap tier on, a preemption every 3 steps
OVL_SOAK_LENS = (200, 260, 310, 230, 350, 280, 220, 400, 330, 240, 290, 210)
OVL_SOAK_TOKENS, OVL_SOAK_HOST, OVL_SOAK_SEGMENT = 16, 64, 2
SWAP_CHUNKS, SWAP_PAGES, SWAP_REPEATS = (1, 8, 64), 64, 3


def _work_launches(cfg, work, per_layer_gemv: int):
    """The launches a session's work implies for the four kernels of the
    serving path (gemma2-2b: 4 packed projections a layer)."""
    L = cfg.n_layers
    pre, tails = work["prefills"], work["tail_prefills"]
    small = sum(c for b, c in list(pre.items()) + list(tails.items())
                if b <= 256)
    return {"packed_xnor_gemv": per_layer_gemv * L
            * (work["decode_steps"] + small),
            "paged_flash_decode": L * work["decode_steps"],
            "flash_attention_fwd": L * sum(pre.values()),
            "paged_prefix_attention": L * sum(tails.values())}


def _check_launches(cfg, work, totals, label):
    """Hold every kernel's launches since the counts were set to 0 to what
    a session's ``work`` implies (the other kernels at 0), every one on the
    tensor-core route, and add them to ``totals``."""
    from repro_torch.kernels import KERNELS

    launches = {k.__name__: k.launches for k in KERNELS}
    routes = route_counts()
    want = {k: 0 for k in launches}
    want.update(_work_launches(cfg, work, 4))
    assert launches == want, (label, launches, want)
    assert all(r["cuda_cores"] == 0 for r in routes.values()), (label, routes)
    for k, v in launches.items():
        totals[k] = totals.get(k, 0) + v


def _counted(torch, cfg, run, totals, label):
    """Run ``run()`` -> session work with the counts at 0 before, and
    ``_check_launches`` it."""
    zero_counts()
    work = run()
    _check_launches(cfg, work, totals, label)
    return work


def swap_roundtrip_check(torch, cfg, gen):
    """swap_out then swap_in onto other page ids returns every byte of every
    attention leaf (k/v rows; under kv-quant the int8 pools and their fp32
    scale pools), on a pool of phase 13's geometry filled at random; then
    device->host and host->device rates in GB/s for 64 pages moved in
    chunks of 1, 8 and 64 pages (each chunk size warmed once, then the
    median of SWAP_REPEATS round trips, host clock around a synchronize;
    swap_out returns with its bytes on the host)."""
    from repro_torch.serve import paged_pool_init
    from repro_torch.serve.swap import SwapManager

    pool = paged_pool_init(cfg, OVL_POOL_PAGES, 16, "cuda")
    for blk in pool.values():
        for leaf in blk.values():
            if leaf.dtype == torch.int8:
                leaf.copy_(torch.randint(-127, 128, leaf.shape, generator=gen,
                                         device="cuda", dtype=torch.int8))
            else:
                leaf.copy_(torch.randn(leaf.shape, generator=gen,
                                       device="cuda").to(leaf.dtype))
    mgr = SwapManager(cfg, host_pages=SWAP_PAGES)
    perm = torch.randperm(OVL_POOL_PAGES - 1, generator=torch.Generator()
                          .manual_seed(5)) + 1
    src, dst = perm[:SWAP_PAGES].tolist(), perm[SWAP_PAGES:2 * SWAP_PAGES].tolist()
    before = {(bi, n): leaf[:, src].clone() for bi, blk in pool.items()
              for n, leaf in blk.items()}
    out = {"leaves": sorted({n for _, n in before}), "rates": {}}
    slots = mgr.swap_out(pool, src)                # shapes the pinned buffers
    mgr.swap_in(pool, slots, dst)
    torch.cuda.synchronize()
    for (bi, n), b in before.items():
        assert torch.equal(pool[bi][n][:, dst], b), (bi, n)
    nbytes = mgr.page_bytes * SWAP_PAGES
    for chunk in SWAP_CHUNKS:
        mgr.chunk = chunk
        times = []
        for _ in range(SWAP_REPEATS + 1):      # the first warms the chunk
            for bi, blk in pool.items():
                for leaf in blk.values():
                    leaf[:, dst] = 0
            torch.cuda.synchronize()
            t = time.perf_counter()
            slots = mgr.swap_out(pool, src)
            d2h = time.perf_counter() - t
            t = time.perf_counter()
            mgr.swap_in(pool, slots, dst)
            torch.cuda.synchronize()
            times.append((d2h, time.perf_counter() - t))
            for (bi, n), b in before.items():
                assert torch.equal(pool[bi][n][:, dst], b), (chunk, bi, n)
        d2h, h2d = (statistics.median(x) for x in zip(*times[1:]))
        out["rates"][chunk] = {"d2h_GBps": nbytes / d2h / 1e9,
                               "h2d_GBps": nbytes / h2d / 1e9}
    out.update(page_bytes=mgr.page_bytes, pages=SWAP_PAGES)
    print(f"    swap round trip of {SWAP_PAGES} pages ({mgr.page_bytes / 1e6:.2f} "
          f"MB a page over {len(out['leaves'])} leaf kinds {out['leaves']}): "
          "every byte back onto other page ids; "
          + ", ".join(f"chunk {c}: d2h {r['d2h_GBps']:.2f} GB/s, h2d "
                      f"{r['h2d_GBps']:.2f} GB/s"
                      for c, r in out["rates"].items()))
    del pool, mgr
    return out


def overload_traffic(torch, eng, prompts, sync=lambda: None):
    """Drive OVL's traffic through one session of the overload knobs with
    the audit after every step; returns what happened, per request and
    per step, with each admission's kind (cold, swap-resumed,
    recompute-resumed) and its admission-to-token time."""
    from repro_torch.serve import (TERMINAL, RequestStatus, SamplingParams,
                                   ShedError)

    now = [0.0]
    sess = eng.session(lanes=8, page_size=16, segment=8,
                       n_pages=OVL_POOL_PAGES, max_pending=OVL_MAX_PENDING,
                       tenant_page_quota=OVL_TENANT_PAGES,
                       host_page_budget=OVL_HOST_PAGES, audit=True,
                       clock=lambda: now[0])

    def params(i):
        return SamplingParams(max_tokens=OVL_TOKENS, priority=int(i >= OVL_LOW),
                              tenant="ab"[i % 2],
                              deadline_ms=OVL_DEADLINES.get(i))

    reqs, shed_at_submit = {}, {}

    def submit(i):
        try:
            reqs[i] = sess.submit(prompts[i], params(i))._req
        except ShedError as e:
            shed_at_submit[i] = e.reason

    for i in range(OVL_FIRST):
        submit(i)
    nxt, high_in = OVL_FIRST, False
    steps, step_ms, admits, pending_tok = 0, [], [], {}
    max_slots, t0 = 0, time.perf_counter()
    while True:
        if not high_in and sess.work["decode_steps"] >= 2 * sess.segment:
            for i in range(OVL_LOW, len(prompts)):
                submit(i)
            high_in = True
        for _ in range(OVL_PER_STEP if high_in else 0):
            if nxt < OVL_LOW:
                submit(nxt)
                nxt += 1
        if sess.idle and nxt >= OVL_LOW and high_in:
            break
        before = {i: (r.status, len(r.emitted), r.swap is not None,
                      r.preempt_swap) for i, r in reqs.items()}
        d0 = sess.work["decode_steps"]
        t = time.perf_counter()
        sess.step()
        sync()
        t1 = time.perf_counter()
        now[0] += OVL_MS_A_STEP
        steps += 1
        if sess.work["decode_steps"] > d0:
            step_ms.append((t1 - t) * 1e3 / sess.segment)
        max_slots = max(max_slots, sess.swap_mgr.n_used)
        for i, r in reqs.items():
            st, n_em, had_swap, n_swap = before[i]
            if st in (RequestStatus.QUEUED, RequestStatus.PREEMPTED) \
                    and r.lane >= 0:
                kind = "cold" if n_em == 0 else (
                    "swap" if had_swap and r.preempt_swap == n_swap
                    else "recompute")
                pending_tok[i] = (kind, t)
            if i in pending_tok and len(r.emitted) > n_em:
                kind, ta = pending_tok.pop(i)
                admits.append((i, kind, (t1 - ta) * 1e3))
    serve_s = time.perf_counter() - t0
    for r in reqs.values():
        assert r.status in TERMINAL, r
    return {"sess": sess, "reqs": reqs, "shed_at_submit": shed_at_submit,
            "steps": steps, "step_ms": step_ms, "admits": admits,
            "serve_s": serve_s, "max_slots_used": max_slots}


def overload_round(torch, eng, prompts, totals, label):
    """One pool's overload run, its checks and its uninterrupted twin."""
    from repro_torch.serve import RequestStatus, SamplingParams

    zero_counts()
    res = overload_traffic(torch, eng, prompts, torch.cuda.synchronize)
    sess, reqs = res["sess"], res["reqs"]
    got = {}
    _check_launches(eng.cfg, sess.work, got, label)
    for k, v in got.items():
        totals[k] = totals.get(k, 0) + v
    st = sess.stats()
    outcome = {i: (r.status.name, r.fail_reason) for i, r in reqs.items()}
    shed_reasons = sorted(set(res["shed_at_submit"].values()) | {
        r.fail_reason for r in reqs.values() if r.status is RequestStatus.SHED})
    expired = sorted(i for i, r in reqs.items()
                     if r.status is RequestStatus.EXPIRED)
    for i, r in reqs.items():
        if r.status in (RequestStatus.SHED, RequestStatus.EXPIRED,
                        RequestStatus.FAILED):
            assert r.fail_reason in ("queue-full", "tenant-quota",
                                     "host-budget", "deadline"), (i, r)
        if r.status is RequestStatus.EXPIRED:
            assert r.fail_reason == "deadline" and i in OVL_DEADLINES
    swapped = [i for i, r in reqs.items() if r.preempt_swap and
               not r.preempt_recompute and r.status is RequestStatus.DONE]
    recomputed = [i for i, r in reqs.items() if r.preempt_recompute
                  and r.status is RequestStatus.DONE]
    untouched = [i for i, r in reqs.items() if not r.preemptions
                 and r.status is RequestStatus.DONE]
    print(f"  {label}: {res['steps']} steps in {res['serve_s']:.2f} s; "
          f"outcomes {dict(sorted(outcome.items()))}; shed at submit "
          f"{res['shed_at_submit']}; reasons {shed_reasons}; expired "
          f"{expired}; sched {st['sched']}; swap {st['swap']}")
    assert st["sched"]["preempt_swap"] > 0 and st["sched"]["preempt_recompute"] > 0, \
        st["sched"]
    assert swapped, "no swap-resumed request finished"
    assert "deadline" in shed_reasons or expired, (shed_reasons, expired)
    # the same requests served without preemption, on the same card
    ids = swapped + recomputed + untouched
    twin = eng.session(lanes=8, page_size=16, segment=8)
    hs = {i: twin.submit(prompts[i], SamplingParams(max_tokens=OVL_TOKENS))
          for i in ids}
    twin.run_until_idle()
    twin.close()
    alone = {i: h.tokens_so_far() for i, h in hs.items()}
    parting = {i: next((t for t, (a, b) in enumerate(zip(
        reqs[i].emitted, alone[i])) if a != b), None) for i in recomputed}
    same_swap = [i for i in swapped if reqs[i].emitted == alone[i]]
    same_untouched = [i for i in untouched if reqs[i].emitted == alone[i]]
    print(f"  {label}: swap-resumed streams identical to the same request "
          f"served without preemption: {len(same_swap)}/{len(swapped)} "
          f"{swapped}; never-preempted {len(same_untouched)}/{len(untouched)}; "
          f"recompute-resumed {recomputed}, first parting token (None: "
          f"identical) {parting}")
    assert same_swap == swapped, (swapped, same_swap)
    assert same_untouched == untouched, (untouched, same_untouched)
    by_kind = {}
    for _, kind, ms in res["admits"]:
        by_kind.setdefault(kind, []).append(ms)
    ttft = {k: statistics.median(v) for k, v in by_kind.items()}
    decode_tokens = sum(len(r.emitted) for r in reqs.values())
    out = {"steps": res["steps"], "serve_s": res["serve_s"],
           "step_ms_median": statistics.median(res["step_ms"]),
           "tokens": decode_tokens,
           "tokens_per_s": decode_tokens / res["serve_s"],
           "admit_to_token_ms_median": ttft,
           "admissions_by_kind": {k: len(v) for k, v in by_kind.items()},
           "outcomes": outcome, "shed_at_submit": res["shed_at_submit"],
           "sched": st["sched"], "swap": st["swap"],
           "host_pinned_bytes": sess.swap_mgr.host_bytes,
           "peak_host_bytes_used": res["max_slots_used"]
           * sess.swap_mgr.page_bytes,
           "swap_resumed": swapped, "recompute_resumed": recomputed,
           "recompute_first_parting_token": parting,
           "launches": got}
    print(f"  {label}: decode step median {out['step_ms_median']:.2f} ms under "
          f"overload, {out['tokens_per_s']:.1f} tokens/s over the run; "
          f"admission-to-token median by kind "
          + ", ".join(f"{k} {v:.1f} ms ({len(by_kind[k])})"
                      for k, v in ttft.items())
          + f"; host pinned {out['host_pinned_bytes'] / 1e6:.0f} MB, peak in "
          f"use {out['peak_host_bytes_used'] / 1e6:.0f} MB")
    sess.close()
    return out


def prefix_demotion(torch, eng, rng, totals, label):
    """Four repeats of a shared prompt and a partial hit, close() (the index
    demoted whole to host and parked), then a session of the same geometry
    adopting it: the promoted exact hit's stream identical to the first
    session's, a partial hit over promoted pages read, tail_route_check on
    its prompt."""
    import numpy as np
    from repro_torch.serve import SamplingParams

    V = eng.cfg.vocab_size
    shared = rng.integers(0, V, (OVL_SHARED,)).astype(np.int32)
    partial = [np.concatenate([shared, rng.integers(0, V, (n,)).astype(
        np.int32)]) for n in OVL_PFX_TAILS]
    eng._prefix_store.clear()

    def session():
        return eng.session(lanes=8, page_size=16, segment=8,
                           n_pages=OVL_POOL_PAGES, prefix_cache=True,
                           host_page_budget=OVL_PFX_HOST, audit=True)

    P = SamplingParams(max_tokens=OVL_PFX_TOKENS)
    first = {}

    def run_a():
        s = session()
        h0 = s.submit(shared, P)
        s.run_until_idle()
        hs = [s.submit(shared, P) for _ in range(3)] + [s.submit(partial[0], P)]
        s.run_until_idle()
        first["cold"] = h0.tokens_so_far()
        first["repeats"] = [h.tokens_so_far() for h in hs[:3]]
        first["stats"] = dict(s.prefix.stats)
        work = s.work
        s.close()
        return work

    work_a = _counted(torch, eng.cfg, run_a, totals, label + " prefix A")
    assert eng._prefix_store, "close() parked no index"
    assert first["repeats"] == [first["cold"]] * 3, first
    second = {}

    def run_b():
        s = session()
        second["adopted_host_pages"] = s.prefix.host_resident_pages
        h = s.submit(shared, P)
        s.run_until_idle()
        hp = s.submit(partial[1], P)
        s.run_until_idle()
        second.update(exact=h.tokens_so_far(), partial=hp.tokens_so_far(),
                      exact_admit_ms=h.admit_ms, partial_admit_ms=hp.admit_ms,
                      stats=dict(s.prefix.stats), audit=s.audit())
        work = s.work
        s.close()
        return work

    work_b = _counted(torch, eng.cfg, run_b, totals, label + " prefix B")
    eng._prefix_store.clear()
    st = second["stats"]
    print(f"  {label} prefix: first session {first['stats']}; adopted "
          f"{second['adopted_host_pages']} host-resident pages; second session "
          f"{st}; promoted exact hit admitted in {second['exact_admit_ms']:.1f} "
          f"ms, partial hit over promoted pages in "
          f"{second['partial_admit_ms']:.1f} ms")
    assert second["adopted_host_pages"] > 0 and st["promoted_pages"] > 0, st
    assert st["exact_hits"] >= 1 and st["partial_hits"] >= 1, st
    assert work_b["exact_admits"] == 1 and sum(work_b["tail_prefills"].values()) == 1
    assert second["exact"] == first["cold"], (second["exact"], first["cold"])
    route = tail_route_check(torch, eng, partial[1], OVL_SHARED, 16)
    return {"first": first["stats"], "second": st,
            "adopted_host_pages": second["adopted_host_pages"],
            "promoted_exact_identical": True,
            "promoted_admit_ms": second["exact_admit_ms"],
            "partial_admit_ms": second["partial_admit_ms"],
            "work": [work_a["decode_steps"], work_b["decode_steps"]],
            "tail_route": route}


def seeded_soak(torch, eng, rng, totals):
    """soak_session on FaultSchedule.random(0, DEFAULT_RATES, horizon=64):
    every handle terminal, typed reasons, the audit clean, and every DONE
    greedy stream that was never recomputed identical to the fault-free
    run of the same requests on the card."""
    import numpy as np
    from repro_torch.serve import (DEFAULT_RATES, FaultSchedule,
                                   SamplingParams, soak_session)

    V = eng.cfg.vocab_size
    prompts = [rng.integers(0, V, (n,)).astype(np.int32) for n in OVL_SOAK_LENS]
    P = SamplingParams(max_tokens=OVL_SOAK_TOKENS)
    with eng.session(lanes=8, page_size=16, segment=OVL_SOAK_SEGMENT) as s:
        hs = [s.submit(p, P) for p in prompts]
        s.run_until_idle()
        oracle = [h.tokens_so_far() for h in hs]
    schedule = FaultSchedule.random(0, DEFAULT_RATES, horizon=64)
    made = []

    def make(inj):
        made.append(eng.session(lanes=8, page_size=16,
                                segment=OVL_SOAK_SEGMENT, audit=True,
                                faults=inj, prefix_cache=True,
                                host_page_budget=OVL_SOAK_HOST))
        return made[-1]

    zero_counts()
    rep = soak_session(make, prompts, schedule, params_for=lambda i: P,
                       oracle=lambda i: oracle[i], preempt_period=3,
                       max_steps=500)
    print(f"  soak {rep.summary()}; fired {rep.fired}; "
          f"redispatched segments {made[0].work['redispatched_segments']}")
    assert rep.ok, rep.failures
    assert rep.identity_checked > 0 and rep.fired, rep.summary()
    assert len(made) == 1
    _check_launches(eng.cfg, made[0].work, totals, "soak")
    return {"summary": rep.summary(), "fired": rep.fired,
            "outcomes": {str(k): v for k, v in rep.outcomes.items()},
            "identity_checked": rep.identity_checked,
            "schedule": schedule.to_json(),
            "redispatched_segments": made[0].work["redispatched_segments"]}


def overload(torch, seed: int):
    """Phase 13: overload on gemma2-2b at its published widths (26 layers,
    d_model 2304, bf16, packed, max_len 1024, 8 lanes, page 16), once on a
    bf16 pool and once on an int8 pool: swap_roundtrip_check; OVL's
    traffic with the audit after every step, every request terminal, sheds
    and expiries with the reference's reason strings, swap-resumed (and
    never-preempted) greedy streams identical to the same requests served
    without preemption, recompute-resumed ones read with their first
    parting token; the prefix demotion round; on the bf16 pool one seeded
    soak. Launch counts by route for the four kernels the phase runs, all
    on the tensor-core routes."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models import lm_init
    from repro_torch.serve import ServeEngine, pack_weights

    cfg = get_config("gemma2-2b")
    gc_collect(torch)
    params = pack_weights(lm_init(cfg, torch.Generator(device="cuda")
                                  .manual_seed(seed + 13)), consume=True)
    rng = np.random.default_rng(seed + 13)
    prompts = [rng.integers(0, cfg.vocab_size, (n,)).astype(np.int32)
               for n in OVL_LENS]
    gen = torch.Generator(device="cuda").manual_seed(seed + 13)
    card = smi_line()
    out, totals = {"device": card}, {}
    for quant in (False, True):
        label = "int8 pool" if quant else "bf16 pool"
        eng = ServeEngine(cfg.scaled(kv_cache_quant=quant), params,
                          max_len=1024, packed=True)
        r = {"swap_roundtrip": swap_roundtrip_check(torch, eng.cfg, gen)}
        r["overload"] = overload_round(torch, eng, prompts, totals, label)
        r["prefix"] = prefix_demotion(torch, eng, rng, totals, label)
        if not quant:
            r["soak"] = seeded_soak(torch, eng, rng, totals)
        out[label] = r
        del eng
        gc_collect(torch)
    out["launches"] = totals
    print(f"  phase 13 launches on the tensor-core routes {totals} ({card})")
    return out


# ---------------------------------------------------------------------------
# 14. the gateway: gemma2-2b served over HTTP
# ---------------------------------------------------------------------------
GW_TOKENS, GW_FIRST = 32, 8         # phase 3's 16 prompts, 8 sent at once
GW_LONG = 400                       # a disconnected or lane-holding request
GW_LAUNCH_TOKENS = 16               # the launcher's default --gen
GW_SOAK_TAILS = (40, 25, 60, 33, 17, 48, 70)   # after one 512-token cold run
GW_SOAK_TOKENS, GW_SOAK_HORIZON = 16, 48
GW_WAIT_S = 300.0                   # bound on any one wait of the phase


def _wait_for(cond, what: str, timeout: float = GW_WAIT_S):
    t0 = time.perf_counter()
    while not cond():
        if time.perf_counter() - t0 > timeout:
            raise AssertionError(f"timed out after {timeout:.0f} s waiting "
                                 f"for {what}")
        time.sleep(0.005)


def _http(host, port, method, path, body=None, timeout=60.0):
    """(status, headers, text) of one request on its own connection."""
    import http.client

    conn = http.client.HTTPConnection(host, port, timeout=timeout)
    try:
        conn.request(method, path, None if body is None else (
            body if isinstance(body, str) else json.dumps(body)),
            {"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, dict(resp.getheaders()), resp.read().decode()
    finally:
        conn.close()


class SSEClient:
    """One POST /v1/generate read as it arrives: the client's clock at the
    POST and at the first ``token`` event, the tokens, the one terminal
    event. ``disconnect_after`` tokens, it drops the connection instead."""

    def __init__(self, host, port, body, disconnect_after=None):
        import threading

        self.body = body
        self.first = threading.Event()
        self.status = self.headers = self.t_post = self.t_first = None
        self.tokens, self.terminals, self.error = [], [], None
        self._args = (host, port, disconnect_after)
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self):
        import http.client

        host, port, cut = self._args
        conn = http.client.HTTPConnection(host, port, timeout=GW_WAIT_S)
        try:
            self.t_post = time.perf_counter()
            conn.request("POST", "/v1/generate", json.dumps(self.body),
                         {"Content-Type": "application/json"})
            resp = conn.getresponse()
            self.status, self.headers = resp.status, dict(resp.getheaders())
            if self.headers.get("Content-Type") != "text/event-stream":
                self.terminals.append(("json", json.loads(resp.read())))
                return
            event = None
            while True:
                line = resp.fp.readline().decode()
                if not line:
                    return
                line = line.rstrip("\n")
                if line.startswith("event: "):
                    event = line[7:]
                elif line.startswith("data: ") and event == "token":
                    if self.t_first is None:
                        self.t_first = time.perf_counter()
                        self.first.set()
                    self.tokens.append(int(line[6:]))
                    if cut is not None and len(self.tokens) >= cut:
                        resp.fp.close()
                        return
                elif line.startswith("data: "):
                    self.terminals.append((event, json.loads(line[6:])))
        except Exception as e:                          # noqa: BLE001
            self.error = repr(e)
        finally:
            self.first.set()
            conn.close()

    def join(self):
        self.thread.join(GW_WAIT_S)
        assert not self.thread.is_alive(), ("hung SSE client", self.body)
        assert self.error is None, self.error
        return self


def _step_walls(sess, walls):
    """Record the wall ms a decode step of every decode round of ``sess``
    (each ends in the token harvest, a device synchronisation)."""
    step = sess.step

    def timed():
        d0 = sess.work["decode_steps"]
        t = time.perf_counter()
        out = step()
        if sess.work["decode_steps"] > d0:
            walls.append((time.perf_counter() - t) * 1e3 / sess.segment)
        return out

    sess.step = timed


def _pct(xs, q):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(round(q * (len(xs) - 1))))]


def _first_divergence(torch, engine, prompt, got, want):
    """The first step where ``got`` parts from ``want`` and the margin of
    the served model's logits there (top-1 minus top-2, from a prefill of
    the prompt and the common tokens)."""
    import numpy as np
    from repro_torch.models import lm_prefill

    i = next(k for k, (a, b) in enumerate(zip(got, want)) if a != b)
    ctx = np.concatenate([prompt, np.asarray(want[:i], np.int32)])
    logits, _ = lm_prefill(engine.cfg, engine.params, {
        "tokens": torch.from_numpy(ctx[None]).cuda()})
    top = torch.topk(logits[0, -1, :engine.cfg.vocab_size].float(), 2).values
    return i, float(top[0] - top[1])


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def gateway_traffic(torch, engine, prompts, ref):
    """Phase 14's main path: the 16 prompts over HTTP, 8 at once, 8 more
    once each of the first 8 has its first token, and one ``"stream":
    false`` request (prompt 0 again), through Gateway(engine, lanes=8,
    page_size=16, segment=8). Every stream 32 token events and one ``end``,
    token-identical to the in-process session's (``ref``)."""
    from repro_torch.gateway import Gateway, GatewayHTTP
    from repro_torch.kernels import KERNELS

    gw = Gateway(engine, lanes=8, page_size=16, segment=8)
    step_ms = []
    _step_walls(gw.session, step_ms)
    # when each request reached Gateway.submit (on the event-loop thread)
    # and when it held the gateway lock: {rid: (called, returned)}
    stamps = {}
    submit = gw.submit

    def stamped(prompt, params, request_id=None):
        t = time.perf_counter()
        h = submit(prompt, params, request_id)
        stamps[h.rid] = (t, time.perf_counter())
        return h

    gw.submit = stamped
    srv = GatewayHTTP(gw)
    host, port = srv.start_background()
    try:
        body = [{"prompt": p.tolist(), "max_tokens": GW_TOKENS}
                for p in prompts]
        t0 = time.perf_counter()
        clients = [SSEClient(host, port, b) for b in body[:GW_FIRST]]
        for c in clients:
            assert c.first.wait(GW_WAIT_S), "no first token"
        clients += [SSEClient(host, port, b) for b in body[GW_FIRST:]]
        clients.append(SSEClient(host, port, dict(body[0], stream=False)))
        for c in clients:
            c.join()
        _wait_for(lambda: not gw._tracked and gw.session.idle,
                  "the gateway to go idle")
        traffic_s = time.perf_counter() - t0
        work = {k: (dict(v) if isinstance(v, dict) else v)
                for k, v in gw.session.work.items()}
        launches = {k.__name__: k.launches for k in KERNELS}
        routes = route_counts()
        # every launch since the counts were set to 0 is this traffic's,
        # each on the tensor-core route, as the session's work implies
        _check_launches(engine.cfg, gw.session.work, {}, "gateway")
        for name in ("packed_xnor_gemv", "paged_flash_decode",
                     "flash_attention_fwd"):
            assert launches[name] > 0, launches
        for i, c in enumerate(clients[:-1]):
            assert c.status == 200 and c.headers["Content-Type"] == \
                "text/event-stream", (i, c.status, c.headers)
            assert c.terminals == [("end", {
                "status": "done", "tokens": GW_TOKENS, "preempted": 0,
                "preempted_swap": 0, "preempted_recompute": 0})], \
                (i, c.terminals)
            if c.tokens != ref[i]:
                step, margin = _first_divergence(torch, engine, prompts[i],
                                                 c.tokens, ref[i])
                raise AssertionError(
                    f"request {i}: SSE stream parts from the in-process "
                    f"session at step {step}, logit margin {margin:.4g}")
        (kind, obj), = clients[-1].terminals
        assert clients[-1].status == 200 and kind == "json", clients[-1].status
        assert (obj["event"], obj["status"], obj["tokens"]) == \
            ("end", "done", ref[0]), obj
        _, _, text = _http(host, port, "GET", "/metrics")
        m = {n: float(v) for n, v in (ln.rsplit(" ", 1)
                                     for ln in text.splitlines()
                                     if ln and not ln.startswith("#"))}
        n = len(clients)
        assert m["gateway_ttft_seconds_count"] == n, m
        assert m["serve_sched_admitted_total"] == n
        assert m['gateway_streams_total{outcome="done"}'] == n
        assert m["gateway_tokens_streamed_total"] == n * GW_TOKENS
        assert m['gateway_http_requests_total{code="200",'
                 'path="/v1/generate"}'] == n
        assert not any(k.startswith("serve_work") for k in m)
        ttft = [1e3 * (c.t_first - c.t_post) for c in clients[:-1]]
        marks = [stamps[int(c.headers["X-Request-Id"])] + (c.t_post,)
                 for c in clients[:-1]]
        to_gw = [1e3 * (called - post) for called, _, post in marks]
        lock = [1e3 * (held - called) for called, held, _ in marks]
        itl = gw.metrics.inter_token
        out = {"requests": n, "traffic_s": traffic_s, "work": work,
               "launches": launches, "routes": routes,
               "http_ttft_ms_median": statistics.median(ttft),
               "http_ttft_ms_p90": _pct(ttft, 0.9),
               "step_ms_median": statistics.median(step_ms),
               "step_ms": step_ms,
               "post_to_submit_ms": {"median": statistics.median(to_gw),
                                     "max": max(to_gw)},
               "submit_lock_wait_ms": {"median": statistics.median(lock),
                                       "max": max(lock)},
               "tokens_per_s": n * GW_TOKENS / traffic_s,
               "server_inter_token_s": {
                   "count": itl.n, "p50": itl.quantile(0.5),
                   "p90": itl.quantile(0.9), "mean": itl.sum / max(itl.n, 1)},
               "server_ttft_s": {"count": gw.metrics.ttft.n,
                                 "p50": gw.metrics.ttft.quantile(0.5),
                                 "p90": gw.metrics.ttft.quantile(0.9)}}
        out["protocol"] = gateway_protocol(gw, host, port, prompts, ref)
        return out
    finally:
        srv.stop()
        gw.close()


def gateway_no_http(engine, prompts, ref):
    """The main traffic through a Gateway's step thread with in-process
    submits and no HTTP (no event loop, no client threads): the median
    decode step there, between the plain session's and the one over HTTP,
    says which side of the gateway the step's extra host time is on."""
    from repro_torch.gateway import Gateway
    from repro_torch.serve import SamplingParams

    gw = Gateway(engine, lanes=8, page_size=16, segment=8)
    ms = []
    _step_walls(gw.session, ms)
    try:
        P = SamplingParams(max_tokens=GW_TOKENS)
        hs = [gw.submit(p, P) for p in prompts[:GW_FIRST]]
        _wait_for(lambda: all(h.tokens_ready for h in hs), "first tokens")
        hs += [gw.submit(p, P) for p in prompts[GW_FIRST:] + prompts[:1]]
        _wait_for(lambda: not gw._tracked and gw.session.idle,
                  "the gateway to go idle")
        assert [h.tokens_so_far() for h in hs] == ref + ref[:1]
        return statistics.median(ms)
    finally:
        gw.close()


def gateway_protocol(gw, host, port, prompts, ref):
    """On the main path's gateway, after its traffic: a malformed body is a
    400; a client that disconnects mid-stream is cancelled and its lane and
    pages freed; /healthz is 200, then 503 ``draining`` after begin_drain(),
    new work is refused with 503 + Retry-After, and the stream in flight
    still ends with ``end``, identical to the in-process one."""
    out = {}
    for bad in ({"prompt": "text"}, "not json{",
                {"prompt": [1], "bogus": 1}):
        status, _, text = _http(host, port, "POST", "/v1/generate", bad)
        assert status == 400 and json.loads(text)["error"] == \
            "bad-request", (bad, status, text)
    out["malformed"] = 400
    cut = SSEClient(host, port, {"prompt": prompts[5].tolist(),
                                 "max_tokens": GW_LONG}, disconnect_after=1)
    cut.join()
    _wait_for(lambda: not gw._tracked and gw.session.idle,
              "the disconnected request to be cancelled")
    st = gw.session.stats()
    assert st["active"] == st["pending"] == 0, st
    assert st["pool"]["n_owned"] == 0 and \
        st["pool"]["n_free"] == st["pool"]["n_pages"] - 1, st["pool"]
    _, _, text = _http(host, port, "GET", "/metrics")
    assert 'gateway_streams_total{outcome="cancelled"} 1' in text
    out["disconnect"] = {"pool": st["pool"], "cancelled": 1}
    status, _, text = _http(host, port, "GET", "/healthz")
    assert (status, json.loads(text)) == (200, {"status": "ok"})
    live = SSEClient(host, port, {"prompt": prompts[1].tolist(),
                                  "max_tokens": GW_TOKENS})
    assert live.first.wait(GW_WAIT_S)
    gw.begin_drain()
    status, _, text = _http(host, port, "GET", "/healthz")
    assert (status, json.loads(text)) == (503, {"status": "draining"})
    status, headers, text = _http(host, port, "POST", "/v1/generate",
                                  {"prompt": [1, 2], "max_tokens": 2})
    assert (status, headers.get("Retry-After"), json.loads(text)) == \
        (503, "1", {"error": "draining"}), (status, headers, text)
    live.join()
    assert live.terminals[0][0] == "end" and live.tokens == ref[1]
    _wait_for(lambda: gw.drained, "the gateway to drain")
    out["drain"] = {"healthz": [200, 503], "in_flight": "end"}
    return out


def gateway_queue_full(torch, engine, prompts):
    """A second gateway with one lane and max_pending=2: a request holds
    the lane and two wait; the next POST is a 429 ``queue-full`` whose
    Retry-After is the live depth, ceil((2 + 1) / 1) = 3 rounds."""
    from repro_torch.gateway import Gateway, GatewayHTTP
    from repro_torch.serve import SamplingParams

    gw = Gateway(engine, lanes=1, page_size=16, segment=8, max_pending=2)
    srv = GatewayHTTP(gw)
    host, port = srv.start_background()
    try:
        P = SamplingParams(max_tokens=GW_LONG)
        hs = [gw.submit(prompts[2], P)]
        _wait_for(lambda: gw.session.stats()["active"] == 1, "a busy lane")
        hs += [gw.submit(prompts[i], P) for i in (3, 4)]
        status, headers, text = _http(host, port, "POST", "/v1/generate",
                                      {"prompt": prompts[0].tolist(),
                                       "max_tokens": 8})
        obj = json.loads(text)
        assert (status, headers.get("Retry-After"), obj["error"]) == \
            (429, "3", "queue-full"), (status, headers, obj)
        for h in hs:
            gw.cancel(h)
        return {"status": status, "retry_after": headers["Retry-After"]}
    finally:
        srv.stop()
        gw.close()


def gateway_launcher(seed: int, prompts, ref):
    """``python -m repro_torch.launch.serve --arch gemma2-2b --packed --http
    PORT --lanes 8 --segment 8`` as a process of its own: /healthz 200
    within a bound, two streams, SIGTERM, a drain and exit 0 within a bound.
    The launcher draws its weights from seed 0, so at ``--seed 0`` its
    streams are the in-process session's first 16 tokens."""
    import os
    import signal

    port = _free_port()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "gemma2-2b", "--packed", "--http", str(port), "--lanes", "8",
         "--segment", "8"], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        def listening():
            assert proc.poll() is None, proc.communicate()[0]
            try:
                return _http("127.0.0.1", port, "GET", "/healthz",
                             timeout=5)[0] == 200
            except OSError:
                return False

        _wait_for(listening, "the launcher's /healthz")
        ready_s = time.perf_counter() - t0
        picks = (0, 7)                      # 16- and 20-token prompts
        clients = [SSEClient("127.0.0.1", port,
                             {"prompt": prompts[i].tolist(),
                              "max_tokens": GW_LAUNCH_TOKENS})
                   for i in picks]
        for c in clients:
            c.join()
            assert c.status == 200 and c.terminals[0][0] == "end" and \
                len(c.tokens) == GW_LAUNCH_TOKENS, (c.status, c.terminals)
        same = [c.tokens == ref[i][:GW_LAUNCH_TOKENS]
                for c, i in zip(clients, picks)]
        if seed == 0:
            assert all(same), ("launcher streams differ from the in-process "
                               "session's", same)
        t_term = time.perf_counter()
        proc.send_signal(signal.SIGTERM)
        text, _ = proc.communicate(timeout=120)
        drain_s = time.perf_counter() - t_term
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, (proc.returncode, text)
    lines = [ln for ln in text.splitlines() if ln.startswith("[serve]")]
    built = next(ln for ln in lines if "kernels built in" in ln)
    assert lines[-1] == "[serve] gateway drained; exiting", lines
    build_s = float(built.split("kernels built in ")[1].split("s")[0])
    print(f"  launcher: {built[8:]}; /healthz 200 {ready_s:.1f} s after "
          f"start; two streams of {GW_LAUNCH_TOKENS} identical to the "
          f"in-process session's: {same}; SIGTERM drained and exited 0 in "
          f"{drain_s:.1f} s")
    return {"ready_s": ready_s, "kernel_build_s": build_s,
            "drain_s": drain_s, "identical": same, "exit_code": 0,
            "lines": lines}


def gateway_soak(torch, engine, rng, seed: int, totals):
    """The gateway under FaultSchedule.random(seed, DEFAULT_RATES,
    horizon=48), prefix cache, audit and a queue of 8: one 512-token prompt
    alone, then seven sharing it with other tails at once (partial hits,
    the tail prefill through paged_prefix_attention). Every stream ends in
    ``end`` or a typed ``error`` echoing its request_id (a shed is a typed
    429/503); after the drain the audit is clean and nothing is tracked;
    the launches equal what the session's work implies."""
    import numpy as np
    from repro_torch.gateway import Gateway, GatewayHTTP
    from repro_torch.kernels import KERNELS
    from repro_torch.serve import DEFAULT_RATES, FaultSchedule, reasons

    V = engine.cfg.vocab_size
    shared = rng.integers(0, V, (OVL_SHARED,)).astype(np.int32)
    prompts = [shared] + [np.concatenate([shared, rng.integers(
        0, V, (t,)).astype(np.int32)]) for t in GW_SOAK_TAILS]
    schedule = FaultSchedule.random(seed, DEFAULT_RATES,
                                    horizon=GW_SOAK_HORIZON)
    zero_counts()
    gw = Gateway(engine, lanes=8, page_size=16, segment=8, prefix_cache=True,
                 audit=True, faults=schedule.injector(), max_pending=8)
    srv = GatewayHTTP(gw)
    host, port = srv.start_background()
    try:
        def body(i):
            return {"prompt": prompts[i].tolist(),
                    "max_tokens": GW_SOAK_TOKENS, "request_id": f"soak-{i}"}

        clients = [SSEClient(host, port, body(0)).join()]
        clients += [SSEClient(host, port, body(i))
                    for i in range(1, len(prompts))]
        for c in clients[1:]:
            c.join()
        _wait_for(lambda: not gw._tracked, "the soak to drain")
        with gw.lock:
            audit = gw.session.audit()
            work = gw.session.work
            fired = list(gw.session.faults.fired)
            _check_launches(engine.cfg, work, totals, "gateway soak")
        outcomes = {}
        for i, c in enumerate(clients):
            if c.status != 200:
                (_, obj), = c.terminals
                assert c.status in (429, 503) and obj["error"] in \
                    reasons.SHED_REASONS, (i, c.status, obj)
                outcomes[f"http {c.status}"] = \
                    outcomes.get(f"http {c.status}", 0) + 1
                continue
            (ev, payload), = c.terminals
            assert payload["request_id"] == f"soak-{i}", payload
            if ev == "error":
                assert reasons.base_reason(payload["reason"]) in \
                    reasons.ALL_REASONS, payload
            else:
                assert ev == "end", ev
            outcomes[payload["status"]] = outcomes.get(payload["status"], 0) + 1
        assert work["tail_prefills"], ("no partial hit ran the prefix kernel",
                                       dict(work["prefills"]))
        out = {"schedule": schedule.to_json(), "fired": fired,
               "outcomes": outcomes,
               "prefills": dict(work["prefills"]),
               "tail_prefills": dict(work["tail_prefills"]),
               "audit_owned": audit["alloc"]["n_owned"],
               "launches": {k.__name__: k.launches for k in KERNELS}}
        print(f"  soak: fired {fired}; outcomes {outcomes}; prefills "
              f"{out['prefills']}, tail prefills {out['tail_prefills']}; "
              f"audit clean, nothing tracked")
        return out
    finally:
        srv.stop()
        gw.close()


def serve_gateway(torch, seed: int):
    """Phase 14: gemma2-2b at its published widths served through the
    gateway over real HTTP on the card: the in-process reference, the main
    traffic (launches counted, every stream identical), the protocol, a
    lane-holding second gateway's live 429, the launcher as a process of
    its own, and a soak under a fault storm."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models import lm_init
    from repro_torch.serve import SamplingParams, ServeEngine

    cfg = get_config("gemma2-2b")
    gc_collect(torch)
    t0 = time.perf_counter()
    engine = ServeEngine(cfg, lm_init(cfg, torch.Generator(device="cuda")
                                      .manual_seed(seed)),
                         max_len=1024, packed=True)
    torch.cuda.synchronize()
    print(f"  gemma2-2b {cfg.n_layers} layers d_model {cfg.d_model} vocab "
          f"{cfg.vocab_size} {cfg.dtype}: init + pack "
          f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab_size, (n,)).astype(np.int32)
               for n in QWEN_LENS]             # phase 3's prompts

    # the in-process reference: the same submission pattern, no HTTP
    ref_ms = []
    sess = engine.session(lanes=8, page_size=16, segment=8)
    _step_walls(sess, ref_ms)
    P = SamplingParams(max_tokens=GW_TOKENS)
    hs = [sess.submit(p, P) for p in prompts[:GW_FIRST]]
    while not all(h.tokens_ready for h in hs):
        sess.step()
    hs += [sess.submit(p, P) for p in prompts[GW_FIRST:]]
    sess.run_until_idle()
    ref = [h.tokens_so_far() for h in hs]
    ref_ttft = [h.ttft_ms for h in hs]
    sess.close()
    assert all(len(r) == GW_TOKENS for r in ref)
    no_http_ms = gateway_no_http(engine, prompts, ref)

    zero_counts()
    out = gateway_traffic(torch, engine, prompts, ref)
    out["no_http_step_ms_median"] = no_http_ms
    out["inproc_ttft_ms_median"] = statistics.median(ref_ttft)
    out["inproc_ttft_ms_p90"] = _pct(ref_ttft, 0.9)
    out["inproc_step_ms_median"] = statistics.median(ref_ms)
    card = smi_line()
    out["device"] = card
    print(f"  {out['requests']} requests over HTTP (8 at once, 8 after their "
          f"first tokens, one non-streamed): every SSE stream {GW_TOKENS} "
          f"tokens + end, identical to the in-process session's; launches "
          f"{out['launches']} as the session's work implies, all on the "
          f"tensor-core routes")
    print(f"  TTFT over HTTP median {out['http_ttft_ms_median']:.1f} ms, p90 "
          f"{out['http_ttft_ms_p90']:.1f} ms (in-process: "
          f"{out['inproc_ttft_ms_median']:.1f} / "
          f"{out['inproc_ttft_ms_p90']:.1f} ms); decode step under the "
          f"gateway median {out['step_ms_median']:.2f} ms (in-process "
          f"{out['inproc_step_ms_median']:.2f} ms, the step thread without "
          f"HTTP {no_http_ms:.2f} ms); "
          f"{out['tokens_per_s']:.1f} tokens/s over {out['traffic_s']:.2f} s; "
          f"server inter-token p50 "
          f"{1e3 * out['server_inter_token_s']['p50']:.2f} ms, p90 "
          f"{1e3 * out['server_inter_token_s']['p90']:.2f} ms over "
          f"{out['server_inter_token_s']['count']} tokens ({card})")
    print(f"  a POST reached Gateway.submit a median "
          f"{out['post_to_submit_ms']['median']:.1f} ms (max "
          f"{out['post_to_submit_ms']['max']:.1f}) after it was sent and waited "
          f"{out['submit_lock_wait_ms']['median']:.1f} ms (max "
          f"{out['submit_lock_wait_ms']['max']:.1f}) there for the gateway "
          f"lock; the server's TTFT histogram (from the lock) p50 "
          f"{1e3 * out['server_ttft_s']['p50']:.0f} ms, p90 "
          f"{1e3 * out['server_ttft_s']['p90']:.0f} ms")
    print(f"  protocol: 400 on malformed bodies; a disconnect cancelled, pool "
          f"{out['protocol']['disconnect']['pool']}; /healthz 200 then 503 "
          "draining; the stream in flight ended with end")
    out["queue_full"] = gateway_queue_full(torch, engine, prompts)
    print(f"  a second gateway (1 lane, max_pending 2): 429 queue-full, "
          f"Retry-After {out['queue_full']['retry_after']}")
    out["launcher"] = gateway_launcher(seed, prompts, ref)
    totals = {}
    out["soak"] = gateway_soak(torch, engine, rng, seed, totals)
    out["soak_launches"] = totals
    del out["step_ms"]
    return out


# ---------------------------------------------------------------------------
# 15. the serve mesh (tensor parallelism over torch.distributed)
# ---------------------------------------------------------------------------
# the shard counts whose head-local launches phase 15 holds to the full
# launch: what each card of a 2- or 4-card mesh runs
MESH_TP = (2, 4)
# the launcher's streaming run, in process and as a --shards 1 process
MESH_LAUNCH_ARGS = ("--arch", "gemma2-2b", "--packed", "--stream",
                    "--requests", "8", "--lanes", "4", "--gen", "16")


def head_local_checks(torch, flush, gen, cfg):
    """The launches a rank of a ``tp``-card mesh makes, at tp 2 and 4: its
    head (or column) slice of phase 3's shapes, the unsharded launch plan
    pinned (``plan_kv`` / ``plan_n``), must equal the same heads or columns
    of the full launch bit for bit. paged_flash_decode on a head slice of
    the bf16 and int8 pools (global and a 100-row window, softcap 50);
    flash_attention on a head slice of a 1,024-token prefill; the GEMV on a
    shard-major column slice of wqkv at 8 decode lanes and a 128-row
    prefill. Each slice's launch is timed beside its bound (what one card
    of the mesh would read), and whether the slice's own plan, unpinned,
    would have matched is recorded."""
    import numpy as np
    from repro_torch.kernels import (flash_attention_fwd, pack_bits,
                                     packed_xnor_gemv, paged_flash_decode)

    H, KV, hd = cfg.heads_padded(), cfg.kv_heads_padded(), cfg.head_dim_
    R, cap = H // KV, cfg.attn_logit_softcap
    page, C = 16, 1024 // 16
    rows = []
    q, bt, pos, pools = decode_inputs(torch, gen, KV, R, hd, page, DECODE_POS)
    qf = (8 * torch.randn((H, LOGITS_PROMPT, hd), generator=gen,
                          device="cuda")).to(torch.bfloat16)
    kf, vf = (torch.randn((KV, LOGITS_PROMPT, hd), generator=gen,
                          device="cuda").to(torch.bfloat16) for _ in range(2))
    K, cols = cfg.d_model, (H * hd, KV * hd, KV * hd)
    w = [(torch.randint(0, 2, (K, n), generator=gen, device="cuda",
                        dtype=torch.int8) * 2 - 1).to(torch.int8) for n in cols]
    for tp in MESH_TP:
        # the decode over each pool and window
        for pool, (k_, v_, ks_, vs_) in pools.items():
            for window in (0, 100):
                kw = dict(window=window, softcap_val=cap)
                full = paged_flash_decode(q, k_, v_, bt, pos, ks_, vs_, **kw)
                for r in range(tp):
                    h = slice(r * KV // tp, (r + 1) * KV // tp)

                    def sl(t):
                        return None if t is None else t[:, :, h].contiguous()

                    args = (q[:, h].contiguous(), sl(k_), sl(v_), bt, pos,
                            sl(ks_), sl(vs_))
                    part = paged_flash_decode(*args, **kw, plan_kv=KV)
                    same = bool(torch.equal(part, full[:, h]))
                    assert same, ("decode head slice", tp, r, pool, window)
                    if r or window:
                        continue
                    own = bool(torch.equal(paged_flash_decode(*args, **kw),
                                           full[:, h]))
                    ms = time_ms(torch, lambda: paged_flash_decode(
                        *args, **kw, plan_kv=KV), flush)
                    n_rows = decode_rows(DECODE_POS, page, C, window)
                    row_bytes = hd * k_.element_size() + (4 if ks_ is not None
                                                          else 0)
                    kv_l = KV // tp
                    b_ms, b_by = bound(args[0].numel() * (2 + 4)
                                       + n_rows * kv_l * row_bytes * 2
                                       + bt.numel() * 4 + pos.numel() * 4,
                                       4.0 * n_rows * kv_l * R * hd, "bf16")
                    rows.append({"kernel": "paged_flash_decode", "tp": tp,
                                 "pool": pool, "KV": kv_l, "R": R,
                                 "nsplit_pinned_from_KV": KV,
                                 "equal": same, "unpinned_equal": own,
                                 "ms": ms, "bound_ms": b_ms,
                                 "bound_by": b_by})
        # the flash prefill over a head slice
        full = flash_attention_fwd(qf, kf, vf, causal=True, softcap=cap,
                                   n_rep=R)
        for r in range(tp):
            hq = slice(r * H // tp, (r + 1) * H // tp)
            hk = slice(r * KV // tp, (r + 1) * KV // tp)
            a = (qf[hq].contiguous(), kf[hk].contiguous(), vf[hk].contiguous())
            part = flash_attention_fwd(*a, causal=True, softcap=cap, n_rep=R)
            assert torch.equal(part, full[hq]), ("flash head slice", tp, r)
            if r:
                continue
            ms = time_ms(torch, lambda: flash_attention_fwd(
                *a, causal=True, softcap=cap, n_rep=R), flush)
            pairs = (H // tp) * _live_pairs(LOGITS_PROMPT, 0)
            b_ms, b_by = bound((a[0].numel() * 2 + a[1].numel() * 2) * 2,
                               4.0 * hd * pairs, "bf16")
            rows.append({"kernel": "flash_attention", "tp": tp,
                         "S": LOGITS_PROMPT, "BH": H // tp, "KV": KV // tp,
                         "equal": True, "ms": ms, "bound_ms": b_ms,
                         "bound_by": b_by})
        # the GEMV over a shard-major column slice of wqkv
        sm = torch.cat([x[:, s * x.shape[1] // tp:(s + 1) * x.shape[1] // tp]
                        for s in range(tp) for x in w], dim=1)
        wp = pack_bits(sm, axis=0)
        N = wp.shape[1]
        for M in (8, 128):
            x = torch.randn((M, K), generator=gen,
                            device="cuda").to(torch.bfloat16)
            full = packed_xnor_gemv(x, wp, k_valid=K)
            for r in range(tp):
                wl = wp[:, r * N // tp:(r + 1) * N // tp].contiguous()
                part = packed_xnor_gemv(x, wl, k_valid=K, plan_n=N)
                same = bool(torch.equal(part, full[:, r * N // tp:
                                                   (r + 1) * N // tp]))
                assert same, ("gemv column slice", tp, r, M)
                if r:
                    continue
                own = bool(torch.equal(packed_xnor_gemv(x, wl, k_valid=K),
                                       full[:, :N // tp]))
                ms = time_ms(torch, lambda: packed_xnor_gemv(
                    x, wl, k_valid=K, plan_n=N), flush)
                b_ms, b_by = bound(x.numel() * 2 + wl.numel() * 4
                                   + M * (N // tp) * 4,
                                   2.0 * M * K * (N // tp), "bf16")
                rows.append({"kernel": "packed_xnor_gemv", "tp": tp, "M": M,
                             "K": K, "N": N // tp, "plan_n": N,
                             "equal": same, "unpinned_equal": own, "ms": ms,
                             "bound_ms": b_ms, "bound_by": b_by})
    for r in rows:
        print(f"  tp {r['tp']} {r['kernel']} "
              + ", ".join(f"{k} {r[k]}" for k in ("pool", "M", "S", "KV", "N")
                          if k in r)
              + f": rank 0's slice equal to the full launch's; "
              + (f"unpinned plan equal {r['unpinned_equal']}; "
                 if "unpinned_equal" in r else "")
              + f"{r['ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']})")
    return rows


def mesh_launcher(torch, seed: int):
    """``python -m repro_torch.launch.serve ... --shards 1 --stream`` as a
    process of its own against the same run in this process without a
    mesh: the same streams (the launcher draws its weights from seed 0, so
    at ``--seed 0``); then ``--shards 2`` on one card exits non-zero with
    the oversubscription message."""
    import os

    from repro_torch.launch import serve as launcher

    import io

    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        want = launcher.main(list(MESH_LAUNCH_ARGS))
    inproc_s = time.perf_counter() - t0
    gc_collect(torch)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                          *MESH_LAUNCH_ARGS, "--shards", "1"], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=600)
    proc_s = time.perf_counter() - t0
    assert res.returncode == 0, res.stderr[-4000:]
    got = {}
    for ln in res.stdout.splitlines():
        if ln.startswith("[serve] req") and " +[" in ln:
            i = int(ln.split()[1][3:])
            got.setdefault(i, []).extend(
                json.loads(ln.split(" +", 1)[1].split(" (")[0]))
    same = [got.get(i) == list(t) for i, t in enumerate(want)]
    assert "[serve] tensor-parallel mesh: 1 shards over cuda" in res.stdout
    if seed == 0:
        assert all(same), ("--shards 1 streams differ", same)
    bad = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                          *MESH_LAUNCH_ARGS, "--shards", "2"], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=300)
    refused = bad.returncode != 0 and "CUDA devices are visible" in bad.stderr
    assert refused, (bad.returncode, bad.stderr[-2000:])
    msg = bad.stderr.strip().splitlines()[-1]
    print(f"  launcher --shards 1 --stream as a process: exit 0 in "
          f"{proc_s:.1f} s, {len(want)} streams identical to the in-process "
          f"run's ({inproc_s:.1f} s): {same}; --shards 2 exit "
          f"{bad.returncode}: {msg}")
    return {"identical": same, "process_s": proc_s, "inproc_s": inproc_s,
            "shards2_exit": bad.returncode, "shards2_message": msg}


def serve_mesh(torch, seed: int, ref):
    """Phase 15: gemma2-2b at published widths through a one-rank NCCL
    serve mesh (``make_serve_mesh(1)``; the head gathers before every wo
    and each segment's token check run on the card): a full-bucket
    prefill's logits and phase 3's 16 streams identical to phase 3's
    unsharded engine's, launches as phase 3's formula, the collectives
    counted and timed, the step beside phase 3's; the head-local kernel
    launches of a 2- and 4-card mesh against the full ones
    (``head_local_checks``); ``make_serve_mesh(2)`` refused on one card;
    the launcher's ``--shards``."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.kernels import KERNELS
    from repro_torch.launch.mesh import make_serve_mesh
    from repro_torch.models import lm_init
    from repro_torch.serve import RequestStatus, ServeEngine

    cfg = get_config("gemma2-2b")
    gc_collect(torch)
    t0 = time.perf_counter()
    mesh = make_serve_mesh(1)
    mesh_s = time.perf_counter() - t0
    try:
        make_serve_mesh(2)
        raise AssertionError("make_serve_mesh(2) on one card did not raise")
    except ValueError as e:
        refusal = str(e)
    print(f"  make_serve_mesh(1): NCCL world of one on {mesh.device} in "
          f"{mesh_s:.2f} s; make_serve_mesh(2) refused: {refusal}")
    t0 = time.perf_counter()
    engine = ServeEngine(cfg, lm_init(cfg, torch.Generator(device="cuda")
                                      .manual_seed(seed)),
                         max_len=1024, packed=True, mesh=mesh)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    logits = full_prefill_logits(torch, engine, ref["long_prompt"])
    logits_equal = bool(torch.equal(logits, ref["logits"]))
    assert logits_equal, ("mesh prefill logits differ",
                          (logits - ref["logits"]).abs().max().item())
    print(f"  engine on the mesh (init + pack {setup_s:.1f} s): a "
          f"{LOGITS_PROMPT}-token prefill's logits torch.equal to phase 3's "
          "unsharded engine's")

    for k in mesh.counts:
        mesh.counts[k] = 0
    sess, handles, _, _, serve_s = serve_traffic(torch, engine, ref["prompts"])
    launches = {k.__name__: k.launches for k in KERNELS}
    routes = route_counts()
    counts = dict(mesh.counts)
    want = serve_launches(cfg, sess.work)
    assert launches == want, (launches, want)
    for name in ("packed_xnor_gemv", "flash_attention_fwd", "paged_flash_decode"):
        assert launches[name] > 0 and routes[name] == {
            "tensor_cores": want[name], "cuda_cores": 0}, (name, routes[name])
    d_steps = sess.work["decode_steps"]
    n_prefills = sum(sess.work["prefills"].values())
    # a mesh of one is the unsharded path (no head gather), as in the JAX
    # package; every segment checks its tokens across the ranks
    assert counts == {"head_gathers": 0,
                      "token_gathers": d_steps // sess.segment}, counts
    streams = [h.tokens_so_far() for h in handles]
    same = [a == b for a, b in zip(streams, ref["streams"])]
    assert all(same), ("mesh streams differ from phase 3's", same)
    for h in handles:
        want_status = RequestStatus.CANCELLED if h.rid == SERVE_CANCEL \
            else RequestStatus.DONE
        assert h.status is want_status, (h.rid, h.status)
    stats = sess.stats()["mesh"]
    assert stats == {"shards": 1, "shard_loss_events": 0, "lost": [],
                     "healthy": True}, stats
    sess.close()
    print(f"  served phase 3's {len(handles)} requests in {serve_s:.2f} s: "
          f"every stream identical to phase 3's; launches {launches} as "
          f"phase 3's formula, all on the tensor-core routes; collectives "
          f"{counts} (one token check a segment; at one shard no head "
          "gather)")

    # the decode step of the mesh engine and of an unsharded one from the
    # same seed, in turns (unsharded, mesh, mesh, unsharded): the host's
    # cost per launch drifts within a process, so phase 3's step, read
    # minutes earlier, is no baseline
    plain = ServeEngine(cfg, lm_init(cfg, torch.Generator(device="cuda")
                                     .manual_seed(seed)),
                        max_len=1024, packed=True)
    steps, decode_tokens, decode_s = {"unsharded": [], "mesh": []}, 0, 0.0
    for label, eng in (("unsharded", plain), ("mesh", engine),
                       ("mesh", engine), ("unsharded", plain)):
        seg_ms, toks_n, secs = timed_segments_8(torch, eng, ref["prompts"])
        steps[label].append(statistics.median(seg_ms))
        if label == "mesh":
            decode_tokens, decode_s = decode_tokens + toks_n, decode_s + secs
    del plain
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    H, hd = cfg.heads_padded(), cfg.head_dim_
    x_dec = torch.randn((8, 1, H, hd), device="cuda").to(torch.bfloat16)
    x_pre = torch.randn((1, LOGITS_PROMPT, H, hd),
                        device="cuda").to(torch.bfloat16)
    toks = torch.zeros((8, 8), dtype=torch.int64, device="cuda")
    # the head gather a rank of a larger mesh issues before every wo: here
    # over NCCL at one rank, where it returns its input
    assert torch.equal(mesh.all_gather_heads(x_dec, 2), x_dec)
    gather_dec = time_ms(torch, lambda: mesh.all_gather_heads(x_dec, 2), flush)
    gather_pre = time_ms(torch, lambda: mesh.all_gather_heads(x_pre, 2), flush)
    agree_ms = time_ms(torch, lambda: mesh.agree(toks), flush)
    n = 200
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(n):
        mesh.all_gather_heads(x_dec, 2)
    gather_host_us = (time.perf_counter() - t) / n * 1e6
    torch.cuda.synchronize()
    # where that host time goes: the op of the most self CPU time
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(50):
            mesh.all_gather_heads(x_dec, 2)
        torch.cuda.synchronize()
    top = max(prof.key_averages(), key=lambda e: e.self_cpu_time_total)
    gather_top = {"op": top.key,
                  "self_cpu_us_per_gather": top.self_cpu_time_total / 50}
    step = statistics.median(steps["mesh"])
    print(f"  decode step at 8 lanes, median of its segments, in turns: "
          f"unsharded {steps['unsharded'][0]:.2f}, mesh {steps['mesh'][0]:.2f}"
          f", mesh {steps['mesh'][1]:.2f}, unsharded "
          f"{steps['unsharded'][1]:.2f} ms (phase 3: "
          f"{ref['step_ms_median']:.2f} ms); "
          f"{decode_tokens / decode_s:.1f} tokens/s on the mesh; one head "
          f"gather over "
          f"NCCL {gather_dec:.4f} ms at decode ({tuple(x_dec.shape)}), "
          f"{gather_pre:.4f} ms at a {LOGITS_PROMPT}-token prefill, "
          f"{gather_host_us:.1f} us of host a call (a rank of a larger mesh "
          f"issues {cfg.n_layers} a decode step; most of it "
          f"{gather_top['op']}, {gather_top['self_cpu_us_per_gather']:.1f} "
          f"us of self CPU a gather under the profiler); the segment's token "
          f"check {agree_ms:.4f} ms (its host sync included)")

    gen = torch.Generator(device="cuda").manual_seed(seed + 15)
    local = head_local_checks(torch, flush, gen, cfg)
    del flush
    engine.close()
    mesh.close()
    del engine
    gc_collect(torch)
    launcher = mesh_launcher(torch, seed)
    return {"launches": launches, "routes": routes, "collectives": counts,
            "decode_steps": d_steps, "prefills": n_prefills,
            "serve_s": serve_s, "setup_s": setup_s, "mesh_init_s": mesh_s,
            "logits_equal": logits_equal, "streams_identical": same,
            "step_ms_median": step, "step_ms_in_turns": steps,
            "phase3_step_ms_median": ref["step_ms_median"],
            "decode_tokens_per_s": decode_tokens / decode_s,
            "head_gather_ms_decode": gather_dec,
            "head_gather_ms_prefill": gather_pre,
            "head_gather_host_us": gather_host_us,
            "head_gather_top_host_op": gather_top,
            "token_check_ms": agree_ms, "head_local": local,
            "refusal": refusal, "launcher": launcher, "device": smi_line()}


# ---------------------------------------------------------------------------
# 16. the training mesh (data and head parallelism over torch.distributed)
# ---------------------------------------------------------------------------
MESH_WARMUP, MESH_TIMED, EF_STEPS = 2, 3, 3
# the head- and data-parallel shard counts whose rank-local weight-backward
# launches phase 16 holds to the full launch
TRAIN_TP, TRAIN_DP = (2, 4), (2, 4)
TRAIN_LAUNCH_ARGS = ("--arch", "gemma2-2b", "--mesh", "local", "--steps", "2",
                     "--batch", str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ),
                     "--microbatches", str(TRAIN_MICRO))
# the EF scale: a mean of |g + e| over a stacked leaf (up to 276 M terms)
# summed in another order on the card and the CPU
EF_SCALE_RTOL = 1e-5


def _state_leaves(tree):
    """The tensor leaves of a training state ({"params", "opt"}) in the
    checkpoint's key order."""
    from repro_torch.checkpoint.manager import _flatten
    return _flatten(tree)


def _states_equal(torch, a, b) -> bool:
    fa, fb = _state_leaves(a), _state_leaves(b)
    return fa.keys() == fb.keys() and all(torch.equal(fa[k], fb[k])
                                          for k in fa)


def weight_bwd_slices(torch, flush, gen):
    """The weight-backward launches a rank of a larger training mesh makes
    at one microbatch's shapes (1,024 tokens, bf16): at tp 2 and 4 a rank's
    column slice of the q/k/v votes (its heads' columns of z), each
    ``torch.equal`` to the full launch's columns (the kernel sums each
    output over the tokens in a fixed order, with no split of K that the
    columns could change); at dp 2 and 4 a rank's row block of each of the
    layer's seven projections, the blocks' votes summed in rank order
    within the fp32 tolerance of check_weight_bwd. Rank 0's launches are
    timed beside their bound."""
    from repro_torch.kernels import boolean_weight_bwd

    B, rows = WBWD_TOKENS, []
    ops = {}
    for name, M, N in WBWD_SHAPES:
        x = torch.randn((B, M), generator=gen, device="cuda").to(torch.bfloat16)
        z = torch.randn((B, N), generator=gen, device="cuda").to(torch.bfloat16)
        ops[name] = (x, z, boolean_weight_bwd(x, z))
    torch.cuda.synchronize()
    for tp in TRAIN_TP:
        ms = b_ms = 0.0
        by = []
        for name in ("wq", "wk", "wv"):
            x, z, full = ops[name]
            N = z.shape[1]
            for r in range(tp):
                zr = z[:, r * N // tp:(r + 1) * N // tp].contiguous()
                part = boolean_weight_bwd(x, zr)
                same = bool(torch.equal(part, full[:, r * N // tp:
                                                   (r + 1) * N // tp]))
                assert same, ("weight bwd column slice", name, tp, r)
                if r == 0:
                    ms += time_ms(torch, lambda: boolean_weight_bwd(x, zr),
                                  flush)
                    t, b = bound(x.numel() * 2 + zr.numel() * 2
                                 + x.shape[1] * zr.shape[1] * 4,
                                 2.0 * B * x.shape[1] * zr.shape[1], "bf16")
                    b_ms += t
                    by.append(b)
        rows.append({"split": "tp", "n": tp, "projections": "wq wk wv",
                     "equal": True, "ms": ms, "bound_ms": b_ms,
                     "bound_by": max(set(by), key=by.count)})
    for dp in TRAIN_DP:
        ms = b_ms = worst = 0.0
        by = []
        for name, M, N in WBWD_SHAPES:
            x, z, full = ops[name]
            acc = None
            for r in range(dp):
                xr = x[r * B // dp:(r + 1) * B // dp].contiguous()
                zr = z[r * B // dp:(r + 1) * B // dp].contiguous()
                part = boolean_weight_bwd(xr, zr)
                acc = part if acc is None else acc + part
                if r == 0:
                    ms += time_ms(torch, lambda: boolean_weight_bwd(xr, zr),
                                  flush)
                    t, b = bound(xr.numel() * 2 + zr.numel() * 2 + M * N * 4,
                                 2.0 * (B // dp) * M * N, "bf16")
                    b_ms += t
                    by.append(b)
            torch.cuda.synchronize()
            err = (acc - full).abs().max().item()
            tol = 1e-5 * full.abs().max().item() + 1e-4
            assert err <= tol, ("weight bwd row blocks", name, dp, err, tol)
            worst = max(worst, err / tol)
        rows.append({"split": "dp", "n": dp, "projections": "all seven",
                     "max_err_over_tol": worst, "ms": ms, "bound_ms": b_ms,
                     "bound_by": max(set(by), key=by.count)})
    qkv = [ops[n][:2] for n in ("wq", "wk", "wv")]
    full_ms = sum(time_ms(torch, lambda: boolean_weight_bwd(x, z), flush)
                  for x, z in qkv)
    full_bound = sum(bound(x.numel() * 2 + z.numel() * 2
                           + x.shape[1] * z.shape[1] * 4,
                           2.0 * B * x.shape[1] * z.shape[1], "bf16")[0]
                     for x, z in qkv)
    for r in rows:
        print(f"  {r['split']} {r['n']}: rank 0's weight-backward launches "
              f"({r['projections']}) {r['ms']:.4f} ms, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}); "
              + ("every column slice torch.equal to the full launch's"
                 if r["split"] == "tp" else
                 f"row blocks summed in rank order within "
                 f"{r['max_err_over_tol']:.3f} of the tolerance"))
    print(f"  the full q/k/v launches {full_ms:.4f} ms, bound "
          f"{full_bound:.4f} ms")
    return rows, full_ms, full_bound


def train_mesh_launcher(torch):
    """``python -m repro_torch.launch.train --arch gemma2-2b --mesh local``
    as a process of its own (a one-rank NCCL world it starts), exit 0; then
    ``--model-axis 2`` on that world of one, refused with the divisibility
    message."""
    import os

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                          *TRAIN_LAUNCH_ARGS], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=600)
    proc_s = time.perf_counter() - t0
    assert res.returncode == 0, res.stderr[-4000:]
    assert "[train] mesh {'data': 1, 'model': 1} over cuda" in res.stdout
    summary = [ln for ln in res.stdout.splitlines() if ln.startswith("[train]")]
    bad = subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                          *TRAIN_LAUNCH_ARGS, "--model-axis", "2"], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=300)
    msg = bad.stderr.strip().splitlines()[-1] if bad.stderr.strip() else ""
    assert bad.returncode != 0 and "not divisible by model_axis=2" in msg, \
        (bad.returncode, bad.stderr[-2000:])
    print(f"  launcher --mesh local as a process: exit 0 in {proc_s:.1f} s "
          f"({' | '.join(summary)}); --model-axis 2 exit {bad.returncode}: "
          f"{msg}")
    return {"exit": res.returncode, "process_s": proc_s, "summary": summary,
            "model_axis2_exit": bad.returncode, "model_axis2_message": msg}


def train_mesh(torch, seed: int, then=lambda: None):
    """Phase 16: gemma2-2b at published widths trained through a one-rank
    NCCL training mesh (``make_local_mesh(1)``): (a) ``make_train_step(
    grad_shardings=)`` + ``TrainLoop(shardings=)`` against an unsharded
    run of the same steps, in turns, every loss and every leaf of params
    and optimizer state ``torch.equal`` after every step, the weight
    backward's launches counted; (b) 3 steps of ``ef_signsgd_compressed(
    hybrid_optimizer(...), ("data",))``, one layer's decoded votes and
    residuals held to ``compress_votes`` on the CPU; (c) one NCCL
    all-reduce of a layer's fp32 grads and of its int32 votes, timed; (d)
    the rank-local weight-backward launches of tp 2 / 4 and dp 2 / 4; (e)
    the launcher as a process. ``then`` is called once (a)-(c), the
    sections timed on the host, are done: phase 17 starts its traces
    there, beside (d) and (e)."""
    import numpy as np
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.core.optimizer import (Optimizer, cosine_schedule,
                                            hybrid_optimizer, is_boolean_leaf,
                                            tree_leaves)
    from repro_torch.data import make_pipeline
    from repro_torch.distributed.compression import (VoteOptimizer,
                                                     compress_votes,
                                                     ef_signsgd_compressed)
    from repro_torch.kernels import KERNELS, boolean_weight_bwd
    from repro_torch.launch.mesh import make_local_mesh, mesh_batch_axes
    from repro_torch.distributed.placement import named, place
    from repro_torch.launch.shardings import (train_param_specs,
                                              train_state_specs)
    from repro_torch.models import lm_init
    from repro_torch.train import TrainLoop, make_train_step

    gc_collect(torch)
    cfg = get_config("gemma2-2b")
    t0 = time.perf_counter()
    mesh = make_local_mesh(1)
    mesh_s = time.perf_counter() - t0
    cfg_s = cfg.scaled(batch_axes=mesh_batch_axes(mesh),
                       use_sharding_constraints=True)
    total = MESH_WARMUP + MESH_TIMED

    def opt():
        return hybrid_optimizer(
            eta=cosine_schedule(4.0, total, warmup=total // 20),
            fp_lr=cosine_schedule(1e-3, total, warmup=total // 20))

    def pipeline():
        return make_pipeline(cfg, TRAIN_SEQ, TRAIN_BATCH, seed=seed)

    def init():
        return lm_init(cfg, torch.Generator(device="cuda").manual_seed(seed))

    # (a) the sharded loop and the unsharded one, step by step in turns
    t0 = time.perf_counter()
    params_u = init()
    o_u = opt()
    loop_u = TrainLoop(make_train_step(cfg, o_u, TRAIN_MICRO), params_u,
                       o_u.init(params_u), pipeline(), log_every=1000)
    params = init()
    specs = train_param_specs(params)
    grad_sh = named(mesh, specs)
    params = place(params, grad_sh)
    o_s = opt()
    state = o_s.init(params)
    state_sh = named(mesh, train_state_specs(params, state, specs))
    loop_s = TrainLoop(make_train_step(cfg_s, o_s, TRAIN_MICRO,
                                       grad_shardings=grad_sh),
                       params, state, pipeline(), log_every=1000,
                       shardings=state_sh)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    def one_step(loop):
        torch.cuda.synchronize()
        t = time.perf_counter()
        loop.run(1, install_signal_handlers=False)
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3

    steps = {"unsharded": [], "mesh": []}
    launches = tc = 0
    resident_u = sum(t.numel() * t.element_size() for t in _state_leaves(
        {"params": loop_u.params, "opt": loop_u.opt_state}).values())
    peak_s = 0
    for i in range(total):
        order = ("unsharded", "mesh") if i % 2 == 0 else ("mesh", "unsharded")
        for label in order:
            if label == "mesh":
                torch.cuda.reset_peak_memory_stats()
                zero_counts()
                ms = one_step(loop_s)
                launches += boolean_weight_bwd.launches
                tc += boolean_weight_bwd.tc_launches
                others = {k.__name__: k.launches for k in KERNELS
                          if k is not boolean_weight_bwd}
                assert not any(others.values()), others
                peak_s = max(peak_s, torch.cuda.max_memory_allocated())
            else:
                ms = one_step(loop_u)
            if i >= MESH_WARMUP:
                steps[label].append(ms)
        assert loop_s.history == loop_u.history, (loop_s.history,
                                                  loop_u.history)
        same = _states_equal(torch, {"params": loop_s.params,
                                     "opt": loop_s.opt_state},
                             {"params": loop_u.params,
                              "opt": loop_u.opt_state})
        assert same, ("the mesh's state differs from the unsharded run's", i)
    per_mb = 7 * cfg.n_layers
    want = total * TRAIN_MICRO * per_mb
    assert launches == tc == want, (launches, tc, want)
    # the JAX package's placement on a world of one: every split is one
    # slice, so no collective of any kind is issued
    assert not any(mesh.counts.values()), mesh.counts
    n_leaves = len(_state_leaves({"params": loop_s.params,
                                  "opt": loop_s.opt_state}))
    print(f"  make_local_mesh(1): NCCL world of one on {mesh.device} in "
          f"{mesh_s:.2f} s; both runs set up in {setup_s:.1f} s")
    print(f"  {total} steps of {TRAIN_BATCH} x {TRAIN_SEQ} tokens in "
          f"{TRAIN_MICRO} microbatches: losses equal ("
          + " ".join(f"{x:.4f}" for x in loop_s.history) + f"), all {n_leaves}"
          f" leaves of params and optimizer state torch.equal after every "
          f"step; {launches} weight-backward launches ({per_mb} a microbatch),"
          f" all on the tensor-core route; collectives {mesh.counts} (a "
          "world of one issues none)")
    print(f"  step in turns (timed steps): unsharded "
          + " ".join(f"{x:.1f}" for x in steps["unsharded"]) + " ms, mesh "
          + " ".join(f"{x:.1f}" for x in steps["mesh"]) + " ms; peak during a "
          f"mesh step {peak_s / 2**30:.2f} GiB with the unsharded run's "
          f"{resident_u / 2**30:.2f} GiB of state resident (the mesh run's "
          f"own {(peak_s - resident_u) / 2**30:.2f} GiB)")
    hist = list(loop_s.history)
    # (b) trains on from the mesh run's params with a state of its own
    params = loop_s.params
    del loop_u, params_u, o_u, loop_s, state, o_s
    gc_collect(torch)

    # (b) EF-SignSGD on the same mesh, one layer held to the CPU
    inner = opt()
    seen, marks = {}, {}
    layer_keys = [k for k in sorted(params["blocks"]["b0"])
                  if k in ("attn", "ffn")]

    def b0_leaves(tree):
        out = {}
        for part in layer_keys:
            for proj, leaf in tree["blocks"]["b0"][part].items():
                if isinstance(leaf, dict) and leaf.get("w") is not None:
                    out[f"{part}/{proj}"] = leaf["w"]
        return out

    def inner_update(grads, st, ps, shardings=None):
        marks["inner"] = torch.cuda.Event(enable_timing=True)
        marks["inner"].record()
        marks["inner_t"] = time.perf_counter()
        if seen.get("capture"):
            seen["dec"] = {k: v[0].to("cpu", copy=True)
                           for k, v in b0_leaves(grads).items()}
        out = inner.update(grads, st, ps, shardings=shardings)
        torch.cuda.synchronize()
        marks["inner_host_s"] = time.perf_counter() - marks["inner_t"]
        return out

    ef = ef_signsgd_compressed(Optimizer(inner.init, inner_update), ("data",))

    def ef_update(grads, st, ps, shardings=None):
        if seen.get("capture"):
            seen["g"] = {k: v.to("cpu", copy=True)
                         for k, v in b0_leaves(grads).items()}
            seen["e0"] = {k: v.to("cpu", copy=True)
                          for k, v in b0_leaves(st.error).items()}
        torch.cuda.synchronize()
        marks["ef"] = torch.cuda.Event(enable_timing=True)
        marks["ef"].record()
        t = time.perf_counter()
        out = ef.update(grads, st, ps, shardings=shardings)
        marks["ef_host_us"] = (marks["inner_t"] - t) * 1e6
        if seen.get("capture"):
            seen["e1"] = {k: v[0].to("cpu", copy=True) for k, v in
                          b0_leaves(out[1].error).items()}
        return out

    opt_ef = VoteOptimizer(ef.init, ef_update, ef.vote_axes)
    state_ef = opt_ef.init(params)
    err_bytes = sum(t.numel() * t.element_size()
                    for t in tree_leaves(state_ef.error))
    n_bool = sum(p.numel() for p in tree_leaves(params)
                 if is_boolean_leaf(p))
    # the votes are taken on grads whole over "data": the Boolean leaves
    # stay whole over it (one slice on a world of one either way)
    step_ef = make_train_step(cfg_s, opt_ef, TRAIN_MICRO,
                              grad_shardings=named(mesh, train_param_specs(
                                  params, boolean_fsdp=False)))
    pipe = pipeline()
    ef_flips, ef_ms, ef_host_us, ef_loss = [], [], [], []
    torch.cuda.reset_peak_memory_stats()
    for i in range(EF_STEPS):
        seen["capture"] = i == EF_STEPS - 1
        batch = {k: torch.from_numpy(v).cuda()
                 for k, v in pipe.batch_at(total + i).items()}
        params, state_ef, m = step_ef(params, state_ef, batch)
        torch.cuda.synchronize()
        ef_loss.append(float(m["loss"]))
        ef_ms.append(marks["ef"].elapsed_time(marks["inner"]))
        ef_host_us.append(marks["ef_host_us"])
        ef_flips.append(sum(float(f) for f in
                            tree_leaves(state_ef.inner.boolean.flips)))
    ef_peak = torch.cuda.max_memory_allocated()
    assert all(math.isfinite(x) for x in ef_loss), ef_loss
    check = {}
    for key, g in seen["g"].items():
        dec, err = compress_votes(g, seen["e0"][key], None)
        got_dec, got_err = seen["dec"][key], seen["e1"][key]
        same_sign = bool(torch.equal(torch.sign(got_dec), torch.sign(dec[0])))
        scale_card, scale_cpu = got_dec.abs().max().item(), \
            dec[0].abs().max().item()
        scale_rel = abs(scale_card - scale_cpu) / scale_cpu
        want_err = err[0].float()
        gap = (got_err.float() - want_err).abs()
        # one bf16 ulp of each residual (2^-7 of it), and a scale's
        # rounding where the residual is near 0
        ulp = torch.maximum(want_err.abs() * 2.0 ** -7,
                            torch.tensor(scale_cpu * 2.0 ** -20))
        err_ok = bool((gap <= ulp).all())
        check[key] = {"signs_equal": same_sign, "scale_rel_err": scale_rel,
                      "residual_within_one_ulp": err_ok}
        assert same_sign and scale_rel <= EF_SCALE_RTOL and err_ok, \
            (key, check[key])
    print(f"  EF-SignSGD, {EF_STEPS} steps: losses "
          + " ".join(f"{x:.4f}" for x in ef_loss) + "; flips "
          + " ".join(f"{x:.0f}" for x in ef_flips) + "; compression "
          + " ".join(f"{x:.2f}" for x in ef_ms) + " ms of device and "
          + " ".join(f"{x:.0f}" for x in ef_host_us) + " us of host a step;"
          f" residual state {err_bytes / 2**30:.2f} GiB; peak "
          f"{ef_peak / 2**30:.2f} GiB; votes {n_bool * 4 / 2**30:.2f} GiB of "
          f"int32 a step against {n_bool * 4 / 2**30:.2f} GiB of fp32 grads")
    print(f"  layer 0's {len(check)} Boolean leaves against compress_votes "
          f"on the CPU: signs equal, scales within "
          f"{max(c['scale_rel_err'] for c in check.values()):.2e} (bound "
          f"{EF_SCALE_RTOL:g}), residuals within one bf16 ulp")
    del seen["g"], seen["e0"]

    # (c) one all-reduce of a layer's grads and of its votes over NCCL
    layer = sum(v[0].numel() for v in b0_leaves(params).values())
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    reduce_rows = {}
    for name, dtype in (("fp32 grads", torch.float32),
                        ("int32 votes", torch.int32)):
        buf = torch.ones(layer, dtype=dtype, device="cuda")
        dev_ms = time_ms(torch, lambda: dist.all_reduce(buf), flush)
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(50):
            dist.all_reduce(buf)
        host_us = (time.perf_counter() - t) / 50 * 1e6
        torch.cuda.synchronize()
        reduce_rows[name] = {"elements": layer, "bytes": layer * 4,
                             "ms": dev_ms, "host_us": host_us}
        del buf
    print("  one NCCL all-reduce of layer 0's Boolean grads (world of one), "
          + "; ".join(f"{k}: {v['bytes'] / 2**20:.1f} MiB, {v['ms']:.4f} ms "
                      f"of device, {v['host_us']:.1f} us of host"
                      for k, v in reduce_rows.items()))
    del params, state_ef, step_ef, opt_ef, ef, inner
    mesh.close()
    gc_collect(torch)

    then()
    # (d) the rank-local weight-backward launches of larger meshes
    gen = torch.Generator(device="cuda").manual_seed(seed + 16)
    slices, full_ms, full_bound = weight_bwd_slices(torch, flush, gen)
    del flush
    gc_collect(torch)

    # (e) the launcher as a process
    launcher = train_mesh_launcher(torch)
    return {"launches": {"boolean_weight_bwd": launches},
            "tc_launches": tc, "steps": total, "losses": hist,
            "step_ms_in_turns": steps,
            "step_ms_median": statistics.median(steps["mesh"]),
            "unsharded_step_ms_median": statistics.median(steps["unsharded"]),
            "peak_bytes_during_mesh_step": peak_s,
            "unsharded_resident_bytes": resident_u,
            "mesh_init_s": mesh_s, "setup_s": setup_s,
            "leaves_compared": n_leaves,
            "ef": {"losses": ef_loss, "flips": ef_flips,
                   "device_ms": ef_ms, "host_us": ef_host_us,
                   "error_state_bytes": err_bytes, "peak_bytes": ef_peak,
                   "vote_payload_bytes": n_bool * 4,
                   "fp32_grad_bytes": n_bool * 4, "layer0_check": check},
            "all_reduce": reduce_rows, "weight_bwd_slices": slices,
            "weight_bwd_full_qkv_ms": full_ms,
            "weight_bwd_full_qkv_bound_ms": full_bound, "launcher": launcher,
            "device": smi_line()}


# ---------------------------------------------------------------------------
# 17. dry run and roofline
# ---------------------------------------------------------------------------
DRYRUN_SHAPES = ("train_4k", "prefill_32k", "decode_32k")
# phase 17's one-rank cells of gemma2-2b: (name, seq_len, batch, kind,
# microbatches); train is phase 5's traffic, prefill one 32,768-token row,
# decode 8 rows over a 32,768-row contiguous cache for DECODE_STEPS steps
CELLS = (("train", 512, 4, "train", 2), ("prefill", 32768, 1, "prefill", 1),
         ("decode", 32768, 8, "decode", 1))
DECODE_STEPS, CELL_WARMUP, CELL_TIMED = 16, 1, 3
# a cell's profiled call by kernel group: the port's kernels, the GEMMs,
# then the elementwise widening and scaling of the int8 leaves and cache
CELL_GROUPS = (("boolean_weight_bwd", ("weight_bwd", "ring_kernel")),
               ("flash_attention", ("flash_tc", "flash_fwd")),
               ("gemm", ("gemm", "sm90_", "cutlass", "nvjet")),
               ("copy (dtype widening)", ("copy",)),
               ("mul", ("mul",)))
MATMUL_N, COPY_BYTES = 8192, 4 << 30
# phase 17's rank cell: rank 0 of gemma2-2b's train_4k on the single-pod
# 16 x 16 mesh, the JAX package's placement (launch/shardings.py), its
# microbatch of 4 rows x 4,096 tokens; the cell's 4 microbatches cut to 1
# (a global batch of 16 data ranks x 4 rows): (name, seq_len, global
# batch, microbatches, (data, model))
RANK_CELL = ("train_16x16_rank0", 4096, 64, 1, (16, 16))
# phase 17's serving rank cells: rank 0 of gemma2-2b's prefill_32k (2 rows
# x 32,768 tokens, 1 of 16 q heads over 1 KV head) and decode_32k (8 rows
# over a 2,048-row int8 slab, DECODE_STEPS steps) on the 16 x 16 mesh under
# the JAX package's placement; their traces are the sweep's (a) records of
# the same cells: (name, the sweep's shape)
SERVE_RANK_CELLS = (("prefill_16x16_rank0", "prefill_32k"),
                    ("decode_16x16_rank0", "decode_32k"))
# row 4 at the prefill rank's head-local shape (2 rows x 1 q head over 1
# KV head, hd 256, bf16, softcap 50) against its plain version, at
# sequences whose 64 x 32 blocks the plain version runs in seconds (the
# cell's 32,768 would take minutes): (label, S, window)
RANK_FLASH_CASES = (("global", 4096, 0), ("local", 8192, 4096))
# traces one cell on a fake world, of one or of RANK_CELL's mesh (argv:
# name, seq, batch, kind, microbatches, output file, data, model)
CELL_TRACE = """
import json, sys
from repro_torch.launch.dryrun import trace_cell
from repro_torch.launch.shapes import ShapeDef
name, seq, batch, kind, mb, out, data, model = sys.argv[1:9]
rec = trace_cell("gemma2-2b", ShapeDef(name, int(seq), int(batch), kind),
                 ((int(data), int(model)), ("data", "model")),
                 microbatches=int(mb))
open(out, "w").write(json.dumps(rec, default=str))
"""


def start_dry_runs(out_dir: Path):
    """Phase 17's traces, each a process of its own (a fake world belongs
    to its process), started once phase 16's host-timed sections are done
    so that their host time runs beside the card's: (a) ``python -m repro_torch.launch.dryrun`` on
    gemma2-2b × each of DRYRUN_SHAPES × the single-pod mesh, (b) each
    of CELLS on a fake world of one and RANK_CELL on its mesh. -> {name: (process, record path)};
    every process is killed at exit if still running."""
    import atexit
    import os

    out_dir.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1",
               CUDA_VISIBLE_DEVICES="")
    procs = {}
    for shape in DRYRUN_SHAPES:
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
               "gemma2-2b", "--shape", shape, "--mesh", "single", "--out",
               str(out_dir)]
        procs[shape] = (cmd, out_dir / f"gemma2-2b__{shape}__single__"
                                      "baseline.json")
    for name, seq, batch, kind, mb in CELLS:
        rec = out_dir / f"cell__{name}.json"
        procs[f"cell:{name}"] = ([sys.executable, "-c", CELL_TRACE, name,
                                  str(seq), str(batch), kind, str(mb),
                                  str(rec), "1", "1"], rec)
    name, seq, batch, mb, (dp, tp) = RANK_CELL
    rec = out_dir / f"cell__{name}.json"
    # the trace's shape is the cell's: train_4k at its cut batch
    procs[f"cell:{name}"] = ([sys.executable, "-c", CELL_TRACE, "train_4k",
                              str(seq), str(batch), "train", str(mb),
                              str(rec), str(dp), str(tp)], rec)
    started = {}
    for name, (cmd, rec) in procs.items():
        started[name] = (subprocess.Popen(
            cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True), rec)

    def stop():
        for p, _ in started.values():
            if p.poll() is None:
                p.kill()
                p.communicate()

    atexit.register(stop)
    return started


_RECORDS = {}


def _trace_record(procs, name, timeout=900.0) -> dict:
    if name in _RECORDS:
        return _RECORDS[name]
    p, path = procs[name]
    out, err = p.communicate(timeout=timeout)
    assert p.returncode == 0, f"{name}: exit {p.returncode}\n{err[-3000:]}"
    rec = json.loads(Path(path).read_text())
    assert rec.get("status", "ok") == "ok" and "roofline" in rec, \
        (name, rec.get("error"), rec.get("traceback", "")[-2000:])
    _RECORDS[name] = rec
    return rec


def _cell_steps(torch, name, cfg, seq, batch, mb, seed):
    """(the step of cell ``name`` on the card, its arguments, how many
    launches of which kernel one step makes)."""
    from repro_torch.core.optimizer import hybrid_optimizer
    from repro_torch.models import cache_init, lm_init
    from repro_torch.train import (make_decode_step, make_prefill_step,
                                   make_train_step)

    params = lm_init(cfg, torch.Generator(device="cuda").manual_seed(seed))
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    tok = torch.randint(0, cfg.vocab_size, (batch, seq if name != "decode"
                                            else 1), generator=gen,
                        device="cuda", dtype=torch.int32)
    if name == "train":
        opt = hybrid_optimizer(eta=8.0, fp_lr=1e-3)
        state = opt.init(params)
        batch_d = {"tokens": tok, "labels": torch.roll(tok, -1, 1)}
        step = make_train_step(cfg, opt, mb)
        return (lambda: step(params, state, batch_d),
                {"boolean_weight_bwd": 7 * cfg.n_layers * mb})
    if name == "prefill":
        step = make_prefill_step(cfg)
        return (lambda: step(params, {"tokens": tok}),
                {"flash_attention_fwd": cfg.n_layers})
    cache = cache_init(cfg, batch, seq, "cuda")
    step = make_decode_step(cfg)
    # the last DECODE_STEPS rows of a full context, one step a call
    cache["pos"] = seq - DECODE_STEPS - CELL_WARMUP

    def decode():
        return step(params, cache, {"tokens": tok})
    return decode, {}


def cell_run(torch, name, seq, batch, kind, mb, seed):
    """One of CELLS on the card, through the same entry points and config
    as its trace (``apply_policy`` on a one-rank mesh): a warm-up call,
    then CELL_TIMED calls (decode: DECODE_STEPS steps) timed by CUDA
    events, the peak of allocated bytes over them from a reset after the
    inputs exist, the launches a call makes, and one more call profiled
    (its wall against its device time by CELL_GROUPS)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import KERNELS
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.shapes import ShapeDef
    from repro_torch.launch.shardings import apply_policy

    gc_collect(torch)
    mesh = make_local_mesh(1)
    try:
        cfg = apply_policy(get_config("gemma2-2b"),
                           ShapeDef(name, seq, batch, kind), mesh)
        fn, per_call = _cell_steps(torch, name, cfg, seq, batch, mb, seed)
        for _ in range(CELL_WARMUP):
            fn()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        calls = DECODE_STEPS if name == "decode" else CELL_TIMED
        ms = []
        for _ in range(calls):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            out = fn()
            b.record()
            del out
            torch.cuda.synchronize()
            ms.append(a.elapsed_time(b))
        launches = {k.__name__: k.launches // calls for k in KERNELS
                    if k.launches}
        assert all(k.launches % calls == 0 for k in KERNELS)
        peak = torch.cuda.max_memory_allocated()
        prof = _profiled(torch, fn, kernel_groups=CELL_GROUPS)
        del fn
    finally:
        mesh.close()
        gc_collect(torch)
    return {"step_ms": ms, "median_ms": statistics.median(ms),
            "max_memory_allocated": peak, "launches_per_call": launches,
            "want_launches": per_call, "calls": calls, "profiled": prof}


def rank_cell(torch, seed):
    """RANK_CELL on the card: rank 0 of gemma2-2b's train_4k on the 16 x 16
    mesh at published widths, bf16, real CUDA tensors over torch's "fake"
    backend (``launch.mesh.fake_world(device="cuda")``), through the
    entry points and config of its trace (``apply_policy``,
    ``train_param_specs``, ``place``, ``make_train_step(grad_shardings=)``):
    a warm-up step, then CELL_TIMED steps timed by CUDA events, the peak
    of allocated bytes over them from a reset after the inputs exist, the
    launches of row 3 a step by route. The collectives move nothing, so
    the gathered weights and the sums are not the mesh's: no value is
    compared (the gloo worlds of tests/test_torch_fsdp_step.py and
    test_torch_split_step.py hold them on the CPU, phase 16 on the card)."""
    from repro_torch.configs import get_config
    from repro_torch.core.optimizer import hybrid_optimizer
    from repro_torch.distributed.placement import named, place
    from repro_torch.kernels import KERNELS, boolean_weight_bwd
    from repro_torch.launch.mesh import fake_world
    from repro_torch.launch.shapes import ShapeDef
    from repro_torch.launch.shardings import (apply_policy, kv_replicated,
                                              train_param_specs)
    from repro_torch.models import lm_init
    from repro_torch.train import make_train_step

    name, seq, batch, mb, (dp, tp) = RANK_CELL
    gc_collect(torch)
    t0 = time.perf_counter()
    mesh = fake_world((dp, tp), ("data", "model"), device="cuda")
    try:
        cfg = apply_policy(get_config("gemma2-2b"),
                           ShapeDef("train_4k", seq, batch, "train"), mesh)
        params = lm_init(cfg, torch.Generator(device="cuda").manual_seed(seed))
        sh = named(mesh, train_param_specs(
            params, replicate_kv=kv_replicated(cfg, tp)))
        # this rank's slices; the whole tree goes as its leaves are replaced
        params = place(params, sh)
        gc_collect(torch)
        opt = hybrid_optimizer(eta=8.0, fp_lr=1e-3)
        state = opt.init(params)
        gen = torch.Generator(device="cuda").manual_seed(seed + 1)
        tok = torch.randint(0, cfg.vocab_size, (batch, seq), generator=gen,
                            device="cuda", dtype=torch.int32)
        data = {"tokens": tok, "labels": torch.roll(tok, -1, 1)}
        step = make_train_step(cfg, opt, mb, grad_shardings=sh)
        for _ in range(CELL_WARMUP):
            step(params, state, data)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        counts0 = dict(mesh.counts)
        ms = []
        for _ in range(CELL_TIMED):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            out = step(params, state, data)
            b.record()
            del out
            torch.cuda.synchronize()
            ms.append(a.elapsed_time(b))
        peak = torch.cuda.max_memory_allocated()
        total = torch.cuda.mem_get_info()[1]
        launches = {k.__name__: k.launches // CELL_TIMED for k in KERNELS
                    if k.launches}
        assert all(k.launches % CELL_TIMED == 0 for k in KERNELS)
        tc = boolean_weight_bwd.tc_launches // CELL_TIMED
        counts = {k: (v - counts0[k]) // CELL_TIMED
                  for k, v in mesh.counts.items() if v != counts0[k]}
        del step, state, params, data, tok
    finally:
        mesh.close()
        gc_collect(torch)
    return {"step_ms": ms, "median_ms": statistics.median(ms),
            "max_memory_allocated": peak, "launches_per_call": launches,
            "tc_launches_per_call": tc, "collectives_per_call": counts,
            "calls": CELL_TIMED, "setup_s": setup_s, "mesh": [dp, tp],
            "card_total_bytes": total}


def serve_rank_cells(torch, seed: int, procs, smi: str, n_layers: int):
    """SERVE_RANK_CELLS on the card (``serve_rank_cell``), each against the
    sweep's trace of its cell: the card's peak (what the cell itself
    allocated) within 5% of the traced one, its launches a call equal to
    the trace's (the prefill's row 4 once
    a layer, all on tensor cores), its median against the bound of the
    work it runs (the trace's compute and memory terms: the fake backend
    moves no bytes). -> {name: the cell's readings}."""
    out = {}
    dp, tp = RANK_CELL[4]
    for name, shape in SERVE_RANK_CELLS:
        t0 = time.perf_counter()
        real = serve_rank_cell(torch, seed, shape)
        cell_s = time.perf_counter() - t0
        rec = _trace_record(procs, shape)
        r = rec["roofline"]
        bound_s = max(r["compute_s"], r["memory_s"])
        bound_by = "compute" if r["compute_s"] >= r["memory_s"] else "memory"
        share = bound_s * 1e3 / real["median_ms"]
        traced = rec["peak_bytes_per_device"]
        fake = rec.get("fake_launches", {})
        ratio = traced / real["cell_peak"]
        row4 = real["launches_per_call"].get("flash_attention_fwd", 0)
        assert real["launches_per_call"] == fake, \
            (name, real["launches_per_call"], fake)
        assert abs(ratio - 1.0) <= 0.05, \
            (name, traced, real["cell_peak"], real["held_before_cell"])
        if shape == "prefill_32k":
            # row 4 once a layer, on the rank's q head, on tensor cores
            assert row4 == n_layers and real["tc_launches_per_call"] == row4, \
                real
        print(f"  (b) {name} (rank 0 of {dp} x {tp}: {real['rows']} rows"
              + (f" x 32,768 tokens, {real['calls']} prefills" if
                 shape == "prefill_32k" else
                 f" over a 2,048-row int8 slab, {real['calls']} steps")
              + "; values not compared: the fake backend's collectives move "
              f"no data): traced peak {traced / 2**30:.2f} GiB, card "
              f"max_memory_allocated {real['max_memory_allocated'] / 2**30:.2f}"
              f" GiB less {real['held_before_cell'] / 2**30:.2f} GiB held "
              f"before the cell (traced / card {ratio:.3f}); median "
              f"{real['median_ms']:.2f} ms against the bound of the work it "
              f"ran {bound_s * 1e3:.3f} ms ({bound_by}): {share:.4f} of it; "
              f"the collective term {r['collective_s'] * 1e3:.3f} ms not "
              f"run; launches a call {real['launches_per_call']} = traced "
              f"{fake}" + (f", all {row4} of row 4 on the tensor-core route"
                           if row4 else "")
              + f"; collectives a call {real['collectives_per_call']}; "
              f"{cell_s:.1f} s; {smi}")
        out[name] = {
            "trace": {k: rec[k] for k in (
                "peak_bytes_per_device", "mem_by_kind", "roofline",
                "analytic", "fake_launches", "trace_s", "collective_sites",
                "collectives", "placement") if k in rec},
            "card": real, "run_bound_ms": bound_s * 1e3,
            "run_bound_by": bound_by, "share_of_bound": share,
            "collective_ms": "not run", "traced_over_card_peak": ratio,
            "wall_s": cell_s}
    return out


def serve_rank_cell(torch, seed, shape_name):
    """One of SERVE_RANK_CELLS on the card: rank 0 of gemma2-2b's
    ``shape_name`` cell on the 16 x 16 mesh at published widths, bf16,
    real CUDA tensors over the fake backend, through the entry points and
    config of its trace (``apply_policy``, ``train_param_specs``,
    ``place``, ``make_prefill_step`` / ``make_decode_step(cfg,
    shardings)``, the decode's cache ``cache_init`` at the slab's rows): a
    warm-up call, then CELL_TIMED prefills or DECODE_STEPS decode steps
    timed by CUDA events, the peak of allocated bytes over them from a
    reset after the inputs exist, less what the process held before the
    cell began (the earlier phases' tensors, which the cell's trace does
    not hold), the launches a call by route. No value is compared (the
    fake backend's collectives move nothing; the gloo worlds of
    tests/test_torch_split_serve.py hold the values on the CPU)."""
    from repro_torch.configs import get_config
    from repro_torch.distributed.placement import named, place
    from repro_torch.kernels import KERNELS, flash_attention_fwd
    from repro_torch.launch.mesh import fake_world
    from repro_torch.launch.shapes import SHAPES
    from repro_torch.launch.shardings import (apply_policy, kv_replicated,
                                              train_param_specs)
    from repro_torch.models import cache_init, lm_init
    from repro_torch.train import make_decode_step, make_prefill_step

    shape = SHAPES[shape_name]
    dp, tp = RANK_CELL[4]
    gc_collect(torch)
    held = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    mesh = fake_world((dp, tp), ("data", "model"), device="cuda")
    try:
        cfg = apply_policy(get_config("gemma2-2b"), shape, mesh)
        params = lm_init(cfg, torch.Generator(device="cuda").manual_seed(seed))
        sh = named(mesh, train_param_specs(
            params, replicate_kv=kv_replicated(cfg, tp)))
        # this rank's slices; the whole tree goes as its leaves are replaced
        params = place(params, sh)
        gc_collect(torch)
        b = shape.global_batch // dp
        gen = torch.Generator(device="cuda").manual_seed(seed + 1)
        seq = shape.seq_len if shape.kind == "prefill" else 1
        tok = torch.randint(0, cfg.vocab_size, (b, seq), generator=gen,
                            device="cuda", dtype=torch.int32)
        if shape.kind == "prefill":
            step, calls = make_prefill_step(cfg, sh), CELL_TIMED

            def fn():
                return step(params, {"tokens": tok})[0]
        else:
            step, calls = make_decode_step(cfg, sh), DECODE_STEPS
            state = {"cache": cache_init(cfg, b, shape.seq_len // tp,
                                         "cuda")}
            # the last steps of a full context (rank 0's slab holds the
            # first rows: the new rows land in the last rank's)
            state["cache"]["pos"] = shape.seq_len - DECODE_STEPS - CELL_WARMUP

            def fn():
                logits, state["cache"] = step(params, state["cache"],
                                              {"tokens": tok})
                return logits
        for _ in range(CELL_WARMUP):
            fn()
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        counts0 = dict(mesh.counts)
        ms = []
        for _ in range(calls):
            a = torch.cuda.Event(enable_timing=True)
            b_ = torch.cuda.Event(enable_timing=True)
            a.record()
            out = fn()
            b_.record()
            del out
            torch.cuda.synchronize()
            ms.append(a.elapsed_time(b_))
        peak = torch.cuda.max_memory_allocated()
        launches = {k.__name__: k.launches // calls for k in KERNELS
                    if k.launches}
        assert all(k.launches % calls == 0 for k in KERNELS)
        tc = flash_attention_fwd.tc_launches // calls
        counts = {k: (v - counts0.get(k, 0)) // calls
                  for k, v in mesh.counts.items() if v != counts0.get(k, 0)}
        flash = rank_flash_check(torch, gen, cfg, b, tp) \
            if shape.kind == "prefill" else None
        del step, params, tok, fn
    finally:
        mesh.close()
        gc_collect(torch)
    return {"step_ms": ms, "median_ms": statistics.median(ms),
            "max_memory_allocated": peak, "held_before_cell": held,
            "cell_peak": peak - held, "launches_per_call": launches,
            "tc_launches_per_call": tc, "collectives_per_call": counts,
            "calls": calls, "setup_s": setup_s, "mesh": [dp, tp],
            "rows": b, "flash_check": flash}


def rank_flash_check(torch, gen, cfg, rows: int, tp: int):
    """Row 4 at the prefill rank's head-local shape (``rows`` x hp / tp q
    heads over their KV heads: gemma2-2b's k/v replicated, one KV head a
    rank) against its plain version at RANK_FLASH_CASES, per element (the
    bf16 tolerance of check_flash), on the tensor-core route; the kernel's
    ms (median of 20) beside one timed plain call and the bound. These
    launches are not the cell's: the cell's counts were read before."""
    from repro_torch.kernels import (flash_attention_fwd, flash_attention_plain,
                                     flash_route)

    hd = cfg.head_dim_
    H = rows * cfg.heads_padded() // tp
    KV = rows * (cfg.kv_heads_padded() // tp or 1)
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    out_rows, worst = [], 0.0
    for label, S, window in RANK_FLASH_CASES:
        q = (8 * torch.randn((H, S, hd), generator=gen, device="cuda")) \
            .to(torch.bfloat16)
        k = torch.randn((KV, S, hd), generator=gen, device="cuda") \
            .to(torch.bfloat16)
        v = torch.randn((KV, S, hd), generator=gen, device="cuda") \
            .to(torch.bfloat16)
        kw = dict(causal=True, window=window, softcap=cfg.attn_logit_softcap,
                  n_rep=H // KV)
        route = flash_route(q)
        assert route == "tensor_cores", route
        got = flash_attention_fwd(q, k, v, **kw).float()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        ref = flash_attention_plain(q, k, v, **kw)
        b.record()
        ref = ref.float()
        absv = flash_attention_plain(q, k, v.abs(), **kw).float()
        torch.cuda.synchronize()
        plain_ms = a.elapsed_time(b)
        tol = (2.0 ** -7 + 2.0 ** -12) * absv \
            + 2.0 ** -7 * torch.maximum(got.abs(), ref.abs())
        diff = (got - ref).abs()
        err, ratio = diff.max().item(), (diff / tol).max().item()
        assert bool(torch.isfinite(got).all()) and ratio <= 1.0, \
            f"rank flash {label} S={S}: err/tol {ratio}"
        ms = time_ms(torch, lambda: flash_attention_fwd(q, k, v, **kw), flush)
        pairs = H * _live_pairs(S, window)
        b_ms, b_by = bound((q.numel() * 2 + k.numel() * 2) * q.element_size(),
                           4.0 * hd * pairs, "bf16")
        worst = max(worst, err)
        out_rows.append({"case": label, "S": S, "window": window, "BH": H,
                         "KV": KV, "hd": hd, "route": route,
                         "max_abs_err": err, "max_err_over_tol": ratio,
                         "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                         "bound_by": b_by})
        print(f"      row 4 at the rank's shape, {label} S={S} window "
              f"{window}: {H} q over {KV} KV heads, route {route}, "
              f"max_abs_err={err:.3g} (err/tol {ratio:.3g}); kernel "
              f"{ms:.4f} ms, plain {plain_ms:.1f} ms, bound {b_ms:.4f} ms "
              f"({b_by})")
        del q, k, v, got, ref, absv, diff, tol
    del flush
    return {"rows": out_rows, "max_abs_err": worst}


def datasheet_rates(torch):
    """(c): the achieved bf16 torch.matmul rate at MATMUL_N³ and the
    device-to-device copy rate of COPY_BYTES, CUDA events, median of 10,
    beside the H100_SXM record's peaks: a check of the yardstick."""
    from repro_torch.launch.hlo_analysis import H100_SXM

    n = MATMUL_N
    a = torch.randn((n, n), device="cuda", dtype=torch.bfloat16)
    b = torch.randn((n, n), device="cuda", dtype=torch.bfloat16)
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    mm_ms = time_ms(torch, lambda: torch.matmul(a, b), flush, iters=10)
    del a, b
    src = torch.empty(COPY_BYTES, dtype=torch.uint8, device="cuda")
    dst = torch.empty_like(src)
    cp_ms = time_ms(torch, lambda: dst.copy_(src), flush, iters=10)
    del src, dst, flush
    gc_collect(torch)
    flops = 2.0 * n ** 3
    return {"matmul_n": n, "matmul_ms": mm_ms,
            "matmul_tflops": flops / (mm_ms * 1e-3) / 1e12,
            "peak_bf16_tflops": H100_SXM.peak_flops_bf16 / 1e12,
            "copy_bytes": COPY_BYTES, "copy_ms": cp_ms,
            # a copy reads and writes every byte
            "copy_gb_s": 2.0 * COPY_BYTES / (cp_ms * 1e-3) / 1e9,
            "peak_hbm_gb_s": H100_SXM.hbm_bw / 1e9}


def dry_run(torch, seed: int, procs):
    """Phase 17: (a) the dry run of gemma2-2b × train_4k / prefill_32k /
    decode_32k on the single-pod fake world (each ``ok``; its peak a rank,
    bottleneck and bound; its traced launches of rows 3 and 4); (b) three
    one-rank cells at published widths, each traced on a fake world of one
    and run on the card, and RANK_CELL, rank 0 of the 16 x 16 train mesh
    (``rank_cell``): the trace's peak beside max_memory_allocated (within
    5% for RANK_CELL), the step's median ms beside the roofline bound and
    its share of it (RANK_CELL's bound is its compute and memory terms:
    its collectives, on the fake backend, move nothing), the card's launches equal to the trace's (RANK_CELL's
    all on the tensor-core route); SERVE_RANK_CELLS, rank 0 of the 16 x 16
    prefill and decode cells (``serve_rank_cell``), against the sweep's
    records of the same cells alike (the prefill's row-4 launches all on
    tensor cores, row 4 at its head-local shape against its plain
    version); (c) the achieved matmul and copy rates beside the datasheet
    record's. (b) and (c) run on the card while the sweep's traces, the
    longest, finish on the host."""
    from repro_torch.kernels.packed_xnor import (gemv_source_tiles,
                                                 gemv_tc_tiles)
    from repro_torch.kernels.paged_attention import (attention_source_tiles,
                                                     attention_tc_tiles)

    # a traced launch plans with the tiles it reads from the kernels'
    # source: those the libraries were built with and report
    assert gemv_tc_tiles()[:4] == gemv_source_tiles()[:4], gemv_tc_tiles()
    for lib in ("flash_attention", "paged_prefix_attention"):
        assert attention_tc_tiles(lib)[:2] == attention_source_tiles()[:2], \
            (lib, attention_tc_tiles(lib))
    print("  traced launches plan with the libraries' tiles "
          "(read from csrc/packed_xnor_gemv.cu and csrc/attention_tc.cuh)")
    smi = smi_line()
    out = {"sweep": {}, "cells": {}}
    n_layers = 26
    # the card's work first, the sweep's longest traces still running
    for name, seq, batch, kind, mb in CELLS:
        real = cell_run(torch, name, seq, batch, kind, mb, seed)
        rec = _trace_record(procs, f"cell:{name}")
        bound_s = rec["roofline"]["step_time_lower_bound_s"]
        share = bound_s * 1e3 / real["median_ms"]
        traced = rec["peak_bytes_per_device"]
        fake = rec.get("fake_launches", {})
        assert real["launches_per_call"] == real["want_launches"] == fake, \
            (name, real["launches_per_call"], real["want_launches"], fake)
        print(f"  (b) {name} ({batch} x {seq}, {kind}"
              + (f", {mb} microbatches" if kind == "train" else "")
              + (f", {DECODE_STEPS} steps" if kind == "decode" else "")
              + f"): traced peak {traced / 2**30:.2f} GiB, card "
              f"max_memory_allocated {real['max_memory_allocated'] / 2**30:.2f}"
              f" GiB (traced / card {traced / real['max_memory_allocated']:.3f})"
              f"; median {real['median_ms']:.2f} ms against the bound "
              f"{bound_s * 1e3:.3f} ms ({rec['roofline']['bottleneck']}): "
              f"{share:.4f} of it; launches a call {real['launches_per_call']}"
              f" = traced {fake}; {smi}")
        prof = real["profiled"]
        print(f"      profiled call: wall {prof['wall_ms']:.2f} ms, device "
              f"{prof['device_ms']:.2f} ms over {prof['device_events']} "
              "kernels: " + ", ".join(
                  f"{g} {v:.2f}" for g, v in
                  prof["device_ms_by_group"].items() if v))
        out["cells"][name] = {"trace": {k: rec[k] for k in (
            "peak_bytes_per_device", "mem_by_kind", "roofline", "analytic",
            "fake_launches", "trace_s", "model_flops_total") if k in rec},
            "card": real, "share_of_bound": share,
            "traced_over_card_peak": traced / real["max_memory_allocated"]}
    name, seq, batch, mb, (dp, tp) = RANK_CELL
    t0 = time.perf_counter()
    real = rank_cell(torch, seed)
    cell_s = time.perf_counter() - t0
    rec = _trace_record(procs, f"cell:{name}")
    r = rec["roofline"]
    # the fake backend moves no bytes: the bound of the work this run does
    # is its compute and memory terms; the collective term was not run
    bound_s = max(r["compute_s"], r["memory_s"])
    bound_by = "compute" if r["compute_s"] >= r["memory_s"] else "memory"
    share = bound_s * 1e3 / real["median_ms"]
    traced = rec["peak_bytes_per_device"]
    fake = rec.get("fake_launches", {})
    ratio = traced / real["max_memory_allocated"]
    row3 = real["launches_per_call"].get("boolean_weight_bwd", 0)
    assert real["launches_per_call"] == fake, (real["launches_per_call"], fake)
    assert row3 > 0 and real["tc_launches_per_call"] == row3, real
    assert abs(ratio - 1.0) <= 0.05, (traced, real["max_memory_allocated"])
    print(f"  (b) {name} (rank 0 of {dp} x {tp}: {batch // dp} rows x {seq} "
          f"tokens a microbatch, {mb} microbatch, the cell's 4 cut to 1; "
          "values not compared: the fake backend's collectives move no "
          f"data): traced peak {traced / 2**30:.2f} GiB, card "
          f"max_memory_allocated {real['max_memory_allocated'] / 2**30:.2f}"
          f" GiB (traced / card {ratio:.3f}); median {real['median_ms']:.2f}"
          f" ms against the bound of the work it ran {bound_s * 1e3:.3f} ms "
          f"({bound_by}): {share:.4f} of it; the collective term "
          f"{r['collective_s'] * 1e3:.3f} ms not run; launches a call "
          f"{real['launches_per_call']} = traced {fake}, all {row3} of row 3 "
          f"on the tensor-core route; collectives a call "
          f"{real['collectives_per_call']}; the card's total memory "
          f"{real['card_total_bytes'] / 2**30:.2f} GiB; {cell_s:.1f} s; "
          f"{smi}")
    out["rank_cell"] = {"trace": {k: rec[k] for k in (
        "peak_bytes_per_device", "mem_by_kind", "roofline", "analytic",
        "fake_launches", "trace_s", "collective_sites", "collectives",
        "placement") if k in rec}, "card": real,
        "run_bound_ms": bound_s * 1e3, "run_bound_by": bound_by,
        "share_of_bound": share, "collective_ms": "not run",
        "traced_over_card_peak": ratio, "wall_s": cell_s}
    out["serve_rank_cells"] = serve_rank_cells(torch, seed, procs, smi,
                                               n_layers)
    rates = datasheet_rates(torch)
    print(f"  (c) bf16 torch.matmul {MATMUL_N}^3: {rates['matmul_tflops']:.1f}"
          f" TFLOP/s of the record's {rates['peak_bf16_tflops']:.1f}; "
          f"device-to-device copy of {COPY_BYTES >> 30} GiB: "
          f"{rates['copy_gb_s']:.1f} GB/s of {rates['peak_hbm_gb_s']:.0f}; "
          f"{smi}")
    out["rates"] = rates
    for shape in DRYRUN_SHAPES:
        rec = _trace_record(procs, shape)
        r = rec["roofline"]
        fake = rec.get("fake_launches", {})
        # row 3 in training (7 Boolean projections a layer a microbatch),
        # row 4 in the cold prefill (one a layer), no kernel in decode
        want = {"train_4k": {"boolean_weight_bwd":
                             7 * n_layers * rec.get("microbatches", 0)},
                "prefill_32k": {"flash_attention_fwd": n_layers},
                "decode_32k": {}}[shape]
        assert fake == want, (shape, fake, want)
        print(f"  (a) gemma2-2b × {shape} × 16x16: ok, peak "
              f"{rec['peak_bytes_per_device'] / 2**30:.2f} GiB a rank, "
              f"bottleneck {r['bottleneck']}, step_time_lower_bound_s "
              f"{r['step_time_lower_bound_s']:.6g}, {rec['collectives']['count']}"
              f" collectives ({rec['collectives']['total'] / 2**20:.1f} MiB), "
              f"traced launches {fake}, trace {rec['trace_s']} s")
        out["sweep"][shape] = {k: rec[k] for k in (
            "peak_bytes_per_device", "mem_by_kind", "roofline",
            "collectives", "collective_sites", "fake_launches", "trace_s",
            "microbatches", "placement") if k in rec}
    return out


# ---------------------------------------------------------------------------
# 18. the examples on the card; the families' training; falcon-mamba-7b
#     trained at its published widths
# ---------------------------------------------------------------------------
# serve_lm's runs (its default traffic: gemma2-2b smoke, 4 x 32-token
# prompts, 24 tokens) and train_lm's (--full-100m: 100 steps, a checkpoint
# at 50 and 100, then a run that kept only step 50 resumed with --resume)
SERVE_LM_RUNS = ((), ("--packed",), ("--packed", "--kv-quant"))
TRAIN_LM_ARGS = ("--full-100m", "--steps", "100", "--batch", "8", "--seq",
                 "128")
TRAIN_LM_CUT = 50
FAMILY_TRAIN = ("falcon-mamba-7b", "moonshot-v1-16b-a3b", "arctic-480b",
                "jamba-1.5-large-398b")
# falcon-mamba-7b's flip rule at published widths: its votes are small. At
# phase 5's eta of 4, and at 1,000, no weight of the 3.36 G flipped in 8
# steps: the largest accumulator x weight read 0.1006 at 1,000 (a flip
# needs 1; the accumulators grow with eta until a weight flips), so 1e5
# puts the largest near 10
FALCON_ETA = 1e5
# phase 18 trains falcon-mamba-7b's first 16 of its 64 blocks: at 32
# (phase 10's FALCON_LAYERS) it peaked at 50.49 GiB in 7.65 s a step, and
# the script neared its 1,200 s on a slow host
FALCON_TRAIN_LAYERS = 16


def phase18_launch_cols(p18, name):
    """Phase 18's launches of kernel ``name`` in each example run on the
    card (quickstart, serve_lm's three) and each family's card step, by
    route where the kernel has two: {"phase18_<run>_launches": ...}."""
    runs = {**{k.replace(" ", "_").replace("-", ""): v
               for k, v in p18["examples"].items()
               if k == "quickstart" or k.startswith("serve_lm")},
            **{f"train_{a.split('-')[0]}": v
               for a, v in p18["families_train"].items()}}
    return {f"phase18_{k}_launches": v["routes"].get(name, v["launches"][name])
            for k, v in runs.items()}


def smoke_head_dim_check(torch, seed: int):
    """The three attention kernels' CUDA-core instances at head dim 16 (the
    smoke configs', serve_lm's on the card) against their plain versions at
    serve_lm's shapes (gemma2-2b smoke: its padded q and KV heads, softcap,
    window 32, 8-row pages of 64 rows a lane): the flash prefill on bf16
    and fp32 (32 rows, global and windowed), the decode over bf16 and int8
    pools (4 lanes), the tail prefill of an 8-row tail over a 24-row prefix
    in 3 scattered pages, both pools; each on the route its router names
    (the CUDA-core one: hd 16 has no tensor-core instance). These launches
    are checks, not serve_lm's: the counts are set to 0 after them."""
    from repro_torch.configs import get_smoke
    from repro_torch.kernels import (decode_route, flash_attention_fwd,
                                     flash_attention_plain, flash_route,
                                     paged_flash_decode,
                                     paged_flash_decode_plain,
                                     paged_prefix_attention,
                                     paged_prefix_attention_plain,
                                     prefix_route)

    cfg = get_smoke("gemma2-2b")
    H, KV, hd = cfg.heads_padded(), cfg.kv_heads_padded(), cfg.head_dim_
    assert hd == 16, hd
    cap, win = cfg.attn_logit_softcap, cfg.sliding_window
    gen = torch.Generator(device="cuda").manual_seed(seed + 18)
    worst = {}
    for dt, dtype in (("bf16", torch.bfloat16), ("fp32", torch.float32)):
        for window in (0, win):
            q = (8 * torch.randn((H, 32, hd), generator=gen, device="cuda")
                 ).to(dtype)
            k = torch.randn((KV, 32, hd), generator=gen, device="cuda").to(dtype)
            v = torch.randn((KV, 32, hd), generator=gen, device="cuda").to(dtype)
            kw = dict(causal=True, window=window, softcap=cap, n_rep=H // KV)
            assert flash_route(q) == "cuda_cores"
            out = flash_attention_fwd(q, k, v, **kw).float()
            ref = flash_attention_plain(q, k, v, **kw).float()
            absv = flash_attention_plain(q, k, v.abs(), **kw).float()
            # check_flash's per-element bounds: bf16 p and output roundings,
            # fp32 reassociation
            tol = ((2.0 ** -7 + 2.0 ** -12) * absv + 2.0 ** -7
                   * torch.maximum(out.abs(), ref.abs())) if dt == "bf16" \
                else 2.0 ** -17 * absv
            diff = (out - ref).abs()
            ratio = (diff / tol).max().item()
            assert bool(torch.isfinite(out).all()) and ratio <= 1.0, (
                "flash hd 16", dt, window, ratio)
            worst[f"flash {dt} window {window}"] = diff.max().item()
    R = H // KV
    q, bt, pos, pools = decode_inputs(torch, gen, KV, R, hd, 8,
                                      (0, 7, 30, 55), L=4, max_len=64)
    for pool, (k_, v_, ks_, vs_) in pools.items():
        for window in (0, win):
            args = (q, k_, v_, bt, pos, ks_, vs_)
            kw = dict(window=window, softcap_val=cap)
            assert decode_route(q, k_) == "cuda_cores"
            out = paged_flash_decode(*args, **kw)
            err = (out - paged_flash_decode_plain(*args, **kw)).abs().max().item()
            assert err <= 1e-4, ("decode hd 16", pool, window, err)
            worst[f"decode {pool} window {window}"] = err
    pools, perm = prefix_pools(torch, gen, KV, hd, page=8)
    page_ids = perm[:3].contiguous()
    qp = (8 * torch.randn((H, 8, hd), generator=gen, device="cuda")
          ).to(torch.bfloat16)
    kt = torch.randn((8, KV, hd), generator=gen, device="cuda").to(torch.bfloat16)
    vt = torch.randn((8, KV, hd), generator=gen, device="cuda").to(torch.bfloat16)
    for pool, (k_, v_, ks_, vs_) in pools.items():
        for window in (0, win):
            args = (qp, kt, vt, k_, v_, page_ids, 24, 24, 8, ks_, vs_)
            kw = dict(n_rep=H // KV, window=window, softcap_val=cap)
            assert prefix_route(qp, k_) == "cuda_cores"
            out = paged_prefix_attention(*args, **kw)
            ref = paged_prefix_attention_plain(*args, **kw)
            absv = paged_prefix_attention_plain(
                qp, kt, vt.abs(), k_, v_.abs(), page_ids, 24, 24, 8, ks_,
                vs_, **kw)
            # check_prefix's bound: p rounded to bf16 on one side only
            ratio = ((out - ref).abs()
                     / ((2.0 ** -7 + 2.0 ** -12) * absv)).max().item()
            assert bool(torch.isfinite(out).all()) and ratio <= 1.0, (
                "prefix hd 16", pool, window, ratio)
            worst[f"prefix {pool} window {window}"] = \
                (out - ref).abs().max().item()
    torch.cuda.synchronize()
    print("  the attention kernels' CUDA-core instances at head dim 16 "
          "against their plain versions at serve_lm's shapes, max_abs_err: "
          + ", ".join(f"{k} {v:.3g}" for k, v in worst.items()))
    zero_counts()
    return worst


def examples_on_card(torch, work: Path):
    """The three examples through their own ``main`` on the card: each one's
    asserts, and the launches by route from the counters."""
    import shutil

    from repro_torch.examples import quickstart, serve_lm, train_lm

    out = {"head_dim_16_check": smoke_head_dim_check(torch, 0)}
    # quickstart: 60 full-batch epochs, two Boolean layers voting through
    # row 3 (fp32 x: the CUDA-core route)
    zero_counts()
    t = time.perf_counter()
    acc = quickstart.main(["--device", "cuda"])
    torch.cuda.synchronize()
    launches, routes = _counts()
    want = 2 * quickstart.EPOCHS
    print(f"  quickstart: final acc {acc:.4f} in {time.perf_counter() - t:.1f} "
          f"s; launches {launches}, weight backward by route "
          f"{routes['boolean_weight_bwd']} (expected {want}, CUDA cores)")
    assert acc > 0.8
    assert launches == {k: (want if k == "boolean_weight_bwd" else 0)
                        for k in launches}, launches
    assert routes["boolean_weight_bwd"] == {"tensor_cores": 0,
                                            "cuda_cores": want}
    out["quickstart"] = {"acc": acc, "launches": launches, "routes": routes}

    # serve_lm: its four checks, plain, packed and packed over int8 pools
    for flags in SERVE_LM_RUNS:
        label = " ".join(flags) or "plain"
        zero_counts()
        t = time.perf_counter()
        res = serve_lm.main(["--device", "cuda", *flags])
        torch.cuda.synchronize()
        launches, routes = _counts()
        print(f"  serve_lm {label}: its four checks passed in "
              f"{time.perf_counter() - t:.1f} s; launches {launches}; by "
              f"route {routes}")
        for k in ("paged_flash_decode", "flash_attention_fwd",
                  "paged_prefix_attention"):
            assert launches[k] > 0, (label, k)
        assert (launches["packed_xnor_gemv"] > 0) == ("--packed" in flags)
        assert launches["boolean_weight_bwd"] == 0
        out[f"serve_lm {label}"] = {"launches": launches, "routes": routes,
                                    "prefix_stats": res["prefix_stats"]}

    # train_lm --full-100m: 100 steps (checkpoints at 50 and 100), then a
    # run that kept only the step-50 checkpoint resumed with --resume
    ck, cut = work / "train_lm_ckpt", work / "train_lm_cut"
    shutil.rmtree(cut, ignore_errors=True)
    gc_collect(torch)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    zero_counts()
    loop = train_lm.main(["--device", "cuda", *TRAIN_LM_ARGS, "--ckpt-dir",
                          str(ck)])
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    launches, routes = _counts()
    steps = len(loop.history)
    per_step = vote_launches(torch, loop.params)
    want = steps * per_step
    ms = [dt * 1e3 for dt in loop.step_times[2:]]
    med = statistics.median(ms)
    cfg = train_lm.config(True)
    batch, seq = int(TRAIN_LM_ARGS[4]), int(TRAIN_LM_ARGS[6])
    print(f"  train_lm --full-100m ({cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, vocab {cfg.vocab_size}, {cfg.dtype}): {steps} steps, "
          f"loss {loop.history[0]:.4f} -> {loop.history[-1]:.4f}; median step "
          f"{med:.2f} ms over steps 3-{steps} (each ended by reading its "
          f"loss), {batch * seq / (med / 1e3):.0f} tokens/s; "
          f"max_memory_allocated {peak / 2**30:.3f} GiB above the "
          f"{base / 2**30:.3f} held before; weight-backward launches "
          f"{launches['boolean_weight_bwd']} (expected {want}: {per_step} a "
          f"step), by route {routes['boolean_weight_bwd']}")
    assert launches["boolean_weight_bwd"] == want, (launches, want)
    assert routes["boolean_weight_bwd"] == {"tensor_cores": want,
                                            "cuda_cores": 0}
    assert all(v == 0 for k, v in launches.items()
               if k != "boolean_weight_bwd"), launches
    assert all(math.isfinite(x) for x in loop.history)
    cut.mkdir(parents=True)
    shutil.copytree(ck / f"step_{TRAIN_LM_CUT:09d}",
                    cut / f"step_{TRAIN_LM_CUT:09d}")
    hist = list(loop.history)
    del loop
    gc_collect(torch)
    zero_counts()
    resumed = train_lm.main(["--device", "cuda", *TRAIN_LM_ARGS, "--resume",
                             "--ckpt-dir", str(cut)])
    r_launches, _ = _counts()
    diff = max(abs(a - b) for a, b in zip(resumed.history,
                                          hist[TRAIN_LM_CUT:]))
    print(f"  train_lm --resume from step {TRAIN_LM_CUT}: ran to step "
          f"{resumed.step}; its first {steps - TRAIN_LM_CUT} losses against "
          f"the uninterrupted run's steps {TRAIN_LM_CUT + 1}-{steps}: max "
          f"|diff| {diff:.3g}; weight-backward launches "
          f"{r_launches['boolean_weight_bwd']}")
    assert resumed.step == TRAIN_LM_CUT + steps
    # bit for bit: the restored params, optimizer state and schedule step
    # take the same batches through the same kernels, so a resume that
    # restored less (an accumulator, Adam's moments, the step) parts here
    assert resumed.history[:steps - TRAIN_LM_CUT] == hist[TRAIN_LM_CUT:], diff
    assert r_launches["boolean_weight_bwd"] == steps * per_step
    out["train_lm"] = {
        "config": {"name": cfg.name, "n_layers": cfg.n_layers,
                   "d_model": cfg.d_model, "vocab_size": cfg.vocab_size,
                   "dtype": str(cfg.dtype), "batch": batch, "seq": seq},
        "losses": hist, "step_ms": ms, "step_ms_median": med,
        "tokens_per_s": batch * seq / (med / 1e3),
        "max_memory_allocated_bytes": peak, "launches": launches,
        "routes": routes, "expected_weight_bwd": want,
        "resumed_losses": resumed.history, "resume_max_abs_diff": diff,
        "resumed_launches": r_launches}
    del resumed
    shutil.rmtree(ck, ignore_errors=True)
    shutil.rmtree(cut, ignore_errors=True)
    gc_collect(torch)
    return out


def examples_and_families(torch, seed: int, work: Path):
    """Phase 18."""
    from repro_torch.configs import get_config

    work.mkdir(parents=True, exist_ok=True)
    out = {"examples": examples_on_card(torch, work)}
    # phase 6's check, one step of each family
    out["families_train"] = {arch: train_agree_with_cpu(torch, seed, arch, 1)[0]
                             for arch in FAMILY_TRAIN}
    # falcon-mamba-7b at its published widths, depth cut only, on phase 5's
    # traffic, the selective scan's device time in a group of its own
    cfg = get_config("falcon-mamba-7b").scaled(n_layers=FALCON_TRAIN_LAYERS)
    print(f"  falcon-mamba-7b: {cfg.n_layers} of its 64 blocks, d_inner "
          f"{cfg.d_inner_}, state {cfg.ssm_state}")
    m = train(torch, seed, cfg, FALCON_ETA, (cfg.d_inner_, cfg.ssm_state))
    assert sum(m["flips"]) > 0, m["flips"]
    out["falcon_train"] = m
    return out


def gc_collect(torch):
    import gc
    gc.collect()
    torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=str(ROOT / "build" / "chip_smoke.json"))
    ap.add_argument("--step-probe", action="store_true",
                    help="only read phase 9's decode step fresh and after "
                         "what the earlier phases leave behind (step_probe)")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    if args.step_probe:
        print(f"device: {smi_line()}")
        readings = step_probe(torch, args.seed)
        out = Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps({"device": smi_line(),
                                   "step_probe": readings}, indent=1))
        print(json.dumps([{k: v for k, v in r.items() if k != "step_ms"}
                          for r in readings]))
        return 0
    from repro_torch.configs import get_config
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python "
          f"{sys.version.split()[0]}")
    device_line = smi_line()
    print(f"device: {device_line}")

    walls, launch_at = {}, {}

    @contextlib.contextmanager
    def phase(n: int, title: str):
        print(f"{n}. {title}")
        launch_at[n] = launch_us(torch)
        print(f"  one launch {launch_at[n]:.2f} us of host at the phase's start")
        t = time.perf_counter()
        yield
        walls[n] = time.perf_counter() - t
        print(f"  phase {n} wall {walls[n]:.1f} s")

    gemma, qwen = get_config("gemma2-2b"), get_config("qwen2.5-14b")
    moon = get_config("moonshot-v1-16b-a3b")
    with phase(1, "build"):
        t0 = time.perf_counter()
        secs = build.build_all()
        print(f"  built {secs} in {time.perf_counter() - t0:.1f} s")
        for name in build.SOURCES:
            for line in build.build_log(name).splitlines():
                if "registers" in line or "spill" in line:
                    print(f"  {name}: {line.strip()}")
        # the decode kernel's R 6 instances at qwen2.5-14b's 8 KV heads
        ring = ring_kernels(build, gemma.kv_heads_padded(),
                            {qwen.heads_padded() // qwen.kv_heads_padded():
                             qwen.kv_heads_padded()})
        for label, info in ring.items():
            print(f"  tensor-core kernel {label}: {info}")

    with phase(2, "kernels vs plain versions"):
        gen = torch.Generator(device="cuda").manual_seed(args.seed)
        flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
        gemv_rows, gemv_err = check_gemv(torch, flush, gen)
        qwen_gemv_rows, qwen_gemv_err = check_gemv(
            torch, flush, gen, QWEN_GEMV_SHAPES, (8,), ())
        mamba_gemv_rows, mamba_gemv_err = check_gemv(
            torch, flush, gen, MAMBA_GEMV_SHAPES, (8, 128), ())
        moon_gemv_rows, moon_gemv_err = check_gemv(
            torch, flush, gen, MOON_GEMV_SHAPES, (8,), ())
        dec_rows, dec_err, dec_exact = check_paged_decode(torch, flush, gen,
                                                          gemma)
        flash_rows, flash_err = check_flash(torch, flush, gen, gemma)
        qwen_flash_rows, qwen_flash_err = check_flash(
            torch, flush, gen, qwen, QWEN_FLASH_CASES)
        moon_flash_rows, moon_flash_err = check_flash(
            torch, flush, gen, moon, MOON_FLASH_CASES)
        pfx_rows, pfx_err = check_prefix(torch, flush, gen, gemma)
        uniform = check_uniform(torch, gen, gemma)
        wbwd_rows, wbwd_err = check_weight_bwd(torch, flush, gen)
        tc_rates = tensor_core_rates(torch)
        gemm_rows = check_bool_gemm(torch, flush, gen, tc_rates)
        del flush

    with phase(3, "serve gemma2-2b (published widths) through the packed "
                  "session"):
        engine, launches, metrics, serve_ref = serve(torch, args.seed)

    with phase(4, "small fp32 model: card kernels vs CPU plain versions"):
        metrics.update(agree_with_cpu(torch, args.seed))

    with phase(5, "train gemma2-2b (published widths) through make_train_step "
                  "+ TrainLoop"):
        train_metrics = train(torch, args.seed, get_config("gemma2-2b"), 4.0)

    with phase(6, "small fp32 model training: card kernels vs CPU plain "
                  "versions"):
        train_metrics.update(train_check(torch, args.seed))

    with phase(7, "prefix-cached serving of gemma2-2b (published widths), "
                  "bf16 and int8 KV pools"):
        prefix_metrics = serve_prefix(torch, engine, args.seed)
        del engine

    with phase(8, "Boolean VGG-SMALL and SMALL-EDSR (published widths): "
                  "float, int8 and packed Boolean leaves"):
        vision_metrics = vision(torch, args.seed)

    with phase(9, "serve qwen2.5-14b (published widths), greedy and sampled "
                  "requests, through the packed session"):
        engine, qwen_metrics = serve_qwen(torch, args.seed)
        del engine

    with phase(10, "serve falcon-mamba-7b (published widths) through the "
                   "packed session, then prefix-cached"):
        engine, falcon_metrics = serve_falcon(torch, args.seed)
        del engine
        gc_collect(torch)

    with phase(11, "moonshot, arctic and jamba (smoke widths, fp32) served "
                   "on the card vs the CPU; embeddings frontends"):
        family_metrics = families_agree(torch, args.seed)

    with phase(12, "serve moonshot-v1-16b-a3b (published widths) through the "
                   "packed session"):
        moon_metrics = serve_moonshot(torch, args.seed)
        gc_collect(torch)

    with phase(13, "overload, the host swap tier, faults and chaos on "
                   "gemma2-2b (published widths), bf16 and int8 KV pools"):
        overload_metrics = overload(torch, args.seed)
        gc_collect(torch)

    with phase(14, "serve gemma2-2b (published widths) over HTTP through the "
                   "gateway"):
        gateway_metrics = serve_gateway(torch, args.seed)
        gc_collect(torch)

    with phase(15, "serve gemma2-2b (published widths) through a one-rank "
                   "NCCL serve mesh, and the head-local kernels at tp 2 and "
                   "4"):
        mesh_metrics = serve_mesh(torch, args.seed, serve_ref)
        del serve_ref
        gc_collect(torch)

    # phase 17's traces run on the host beside phase 16's last sections,
    # after those it times on the host
    traces = {}
    with phase(16, "train gemma2-2b (published widths) through a one-rank "
                   "NCCL training mesh, EF-SignSGD, and the rank-local weight "
                   "backward at tp and dp 2 and 4"):
        train_mesh_metrics = train_mesh(torch, args.seed, lambda: traces.update(
            start_dry_runs(Path(args.out).parent / "dryrun")))
        gc_collect(torch)

    with phase(17, "dry run and roofline: gemma2-2b's single-pod cells traced "
                   "on a fake world, three one-rank cells and rank 0 of the "
                   "16 x 16 train, prefill and decode cells traced and run "
                   "on the card, the datasheet rates"):
        dry_metrics = dry_run(torch, args.seed, traces)
        gc_collect(torch)

    with phase(18, "the examples (quickstart, serve_lm, train_lm --full-100m "
                   "and --resume) through their own main on the card; one "
                   "training step of the ssm, moe and hybrid families card "
                   "vs CPU; falcon-mamba-7b trained at its published widths"):
        p18 = examples_and_families(torch, args.seed,
                                    Path(args.out).parent / "phase18")

    rank_prefill = dry_metrics["serve_rank_cells"]["prefill_16x16_rank0"][
        "card"]
    rank_flash = rank_prefill["flash_check"]
    decode_m8 = [r for r in gemv_rows if r["M"] == 8]
    layer_votes = [r for r in wbwd_rows if r["alpha"] == 0.0
                   and r["x_dtype"] == "torch.bfloat16"
                   and r["proj"] in {name for name, _, _ in WBWD_SHAPES}]
    assert len(layer_votes) == len(WBWD_SHAPES)
    local = next(r for r in dec_rows if r["layer"] == "local"
                 and r["pool"] == "bf16")
    local8 = next(r for r in dec_rows if r["layer"] == "local"
                  and r["pool"] == "int8")
    local32 = next(r for r in dec_rows if r["layer"] == "fp32 q local"
                   and r["pool"] == "fp32")
    flash = next(r for r in flash_rows if (r["case"], r["S"], r["dtype"], r["hd"])
                 == ("local", 1024, "bf16", 256))
    pfx = next(r for r in pfx_rows if (r["pool"], r["T"], r["prefix_rows"],
                                       r["window"], r["hd"])
               == ("bf16", 256, PREFIX_ROWS, 0, 256))
    pfx8 = next(r for r in pfx_rows if (r["pool"], r["T"], r["prefix_rows"],
                                        r["window"], r["hd"])
                == ("int8", 256, PREFIX_ROWS, 0, 256))
    p7 = prefix_metrics["bf16"]["launches"]

    def gemm_row(kernel, name):
        """One forward's four VGG ±1 GEMMs, summed, from phase 2; launches
        summed over phase 8's counted runs (VGG without and with BN, EDSR)."""
        rs = [r for r in gemm_rows if r["kernel"] == kernel
              and r["shape"] in {g[0] for g in VGG_GEMMS}]
        runs = [vision_metrics[v][f]["launches"][name]
                for v in ("vgg", "vgg_bn") for f in LEAF_FORMS]
        runs += [vision_metrics["edsr"][f]["launches"][name] for f in LEAF_FORMS]
        lib = [r["library_ms"] for r in rs]
        return {"launches": sum(runs),
                "max_abs_err": max(r["max_abs_err"] for r in gemm_rows
                                   if r["kernel"].startswith(name)),
                "ms": sum(r["ms"] for r in rs),
                "plain_ms": sum(r["plain_ms"] for r in rs),
                "bound_ms": sum(r["bound_ms"] for r in rs),
                "bound_by": ("bytes" if sum(r["bound_by"] == "bytes" for r in rs)
                             * 2 >= len(rs) else "operations"),
                "library_ms": None if None in lib else sum(lib)}

    fused = [r for r in gemm_rows if r["kernel"] == "boolean_matmul fused"
             and r["shape"] in {g[0] for g in VGG_GEMMS}]
    gemv_at = {M: [r for r in gemv_rows if r["M"] == M] for M in GEMV_M}
    q_dec = {pool: next(r for r in dec_rows if r.get("phase") == "phase 9"
                        and r["pool"] == pool) for pool in ("bf16", "int8")}
    q_flash = next(r for r in qwen_flash_rows if r["S"] == 1024)
    m_dec = next(r for r in dec_rows if r.get("phase") == "phase 12"
                 and r["pool"] == "bf16")
    m_flash = moon_flash_rows[0]
    m_launch, m_routes = moon_metrics["launches"], moon_metrics["routes"]
    o_launch = overload_metrics["launches"]
    g_launch = gateway_metrics["launches"]
    g_soak = gateway_metrics["soak_launches"]
    q_launch, q_routes = qwen_metrics["launches"], qwen_metrics["routes"]

    s_launch = mesh_metrics["launches"]

    def tp_cols(kernel, **match):
        """Phase 15's head-local slice of ``kernel`` at each shard count:
        rank 0's launch time and bound (at ``match``'s shape)."""
        out = {}
        for r in mesh_metrics["head_local"]:
            if r["kernel"] == kernel and all(r.get(k) == v
                                             for k, v in match.items()):
                out[f"phase15_tp{r['tp']}_ms"] = r["ms"]
                out[f"phase15_tp{r['tp']}_bound_ms"] = r["bound_ms"]
        return out

    p18_ex = p18["examples"]

    def p18_cols(name):
        return phase18_launch_cols(p18, name)

    def phase11(name):
        """Phase 11's card launches of ``name`` by session (CUDA-core)."""
        return {k: v["launches"][name] for k, v in family_metrics.items()
                if name in v.get("launches", {})}

    kernels = [
        {"name": "packed_xnor_gemv", "route": "cuda",
         "source": "src/repro_torch/csrc/packed_xnor_gemv.cu",
         "replaces": "src/repro/kernels/packed_xnor.py:168",
         "launches": launches["packed_xnor_gemv"],
         "max_abs_err": max(gemv_err, qwen_gemv_err, mamba_gemv_err,
                            moon_gemv_err),
         "ms": sum(r["ms"] for r in decode_m8),
         "plain_ms": sum(r["plain_ms"] for r in decode_m8),
         "bound_ms": sum(r["bound_ms"] for r in decode_m8),
         "bound_by": ("bytes" if sum(r["bound_by"] == "bytes" for r in decode_m8)
                      * 2 >= len(decode_m8) else "operations"),
         "library_ms": sum(r["library_ms"] for r in decode_m8),
         "tc_launches": metrics["gemv_routes"]["tensor_cores"],
         "kernel_route": "tensor_cores",
         **{f"m{M}_{k}": sum(r[k] for r in gemv_at[M])
            for M in GEMV_M[1:] for k in ("ms", "plain_ms", "bound_ms",
                                          "library_ms", "cc_ms")},
         "cc_ms": sum(r["cc_ms"] for r in decode_m8),
         **{f"qwen_{k}": sum(r[k] for r in qwen_gemv_rows)
            for k in ("ms", "plain_ms", "bound_ms", "library_ms", "cc_ms")},
         "phase9_launches": q_launch["packed_xnor_gemv"],
         "phase9_routes": q_routes["packed_xnor_gemv"],
         **{f"falcon_m{M}_{k}": sum(r[k] for r in mamba_gemv_rows
                                   if r["M"] == M)
            for M in (8, 128) for k in ("ms", "plain_ms", "bound_ms",
                                        "library_ms", "cc_ms")},
         "phase10_launches": falcon_metrics["launches"]["packed_xnor_gemv"],
         "phase10_routes": falcon_metrics["routes"]["packed_xnor_gemv"],
         "phase11_launches": phase11("packed_xnor_gemv"),
         **{f"moonshot_{k}": sum(r[k] for r in moon_gemv_rows)
            for k in ("ms", "plain_ms", "bound_ms", "library_ms", "cc_ms")},
         "phase12_launches": m_launch["packed_xnor_gemv"],
         "phase12_routes": m_routes["packed_xnor_gemv"],
         "phase13_launches": o_launch["packed_xnor_gemv"],
         "phase14_launches": g_launch["packed_xnor_gemv"],
         "phase14_soak_launches": g_soak["packed_xnor_gemv"],
         "phase15_launches": s_launch["packed_xnor_gemv"],
         **p18_cols("packed_xnor_gemv"),
         **tp_cols("packed_xnor_gemv", M=8),
         "shape": "sum over one layer's wqkv, wo, wgu, wd at M=8 lanes, bf16 x "
                  "(m16_* .. m256_*: the same at 16 to 256 prefill rows); "
                  "library_ms: torch.matmul on the bf16 ±1 weight; cc_ms: "
                  "the CUDA-core kernel on the same x; tc_launches: phase 3's "
                  "launches on the tensor-core route; qwen_*: the same over "
                  "qwen2.5-14b's six projections (wq, wk, wv, wgu, wo, wd) at "
                  "M=8, phase9_*: phase 9's launches; falcon_m8_* / "
                  "falcon_m128_*: falcon-mamba-7b's five (in_x, in_z, x_proj, "
                  "dt_proj, out_proj) at M=8 and 128, phase10_*: phase 10's "
                  "launches (its serving run), phase11_launches: phase 11's "
                  "card sessions' (fp32 x, the CUDA-core route); moonshot_*: "
                  "moonshot-v1-16b-a3b's wqkv and wo at M=8, phase12_*: "
                  "phase 12's launches; phase13_launches: phase 13's (both "
                  "pools, tensor cores); phase14_launches / phase14_soak_launches: phase 14's over HTTP, its main traffic and its soak; "
                  "phase15_launches: phase 15's through the one-rank serve "
                  "mesh; phase15_tp2_* / phase15_tp4_*: rank 0's shard-major "
                  "column slice of wqkv at M=8 with the unsharded plan "
                  "pinned, what one card of a 2- or 4-card mesh runs"},
        {"name": "paged_flash_decode", "route": "cuda",
         "source": "src/repro_torch/csrc/paged_flash_decode.cu",
         "replaces": "src/repro/kernels/paged_attention.py:156",
         "launches": launches["paged_flash_decode"],
         "max_abs_err": dec_err["tensor_cores"],
         "cc_max_abs_err": dec_err["cuda_cores"],
         "ms": local["ms"], "plain_ms": local["plain_ms"],
         "bound_ms": local["bound_ms"], "bound_by": local["bound_by"],
         "library_ms": None, "kernel_route": "tensor_cores",
         "tc_launches": metrics["routes"]["paged_flash_decode"]["tensor_cores"],
         "cc_ms": local["cc_ms"], "host_us": local["host_us"],
         "cc_host_us": local32["host_us"],
         "int8_ms": local8["ms"], "int8_cc_ms": local8["cc_ms"],
         "int8_plain_ms": local8["plain_ms"],
         "int8_bound_ms": local8["bound_ms"],
         "exact_max_abs_err": max(dec_exact.values()),
         "phase7_routes": {k: v["routes"]["paged_flash_decode"]
                           for k, v in prefix_metrics.items()},
         **{f"qwen_{k}": q_dec["bf16"][k]
            for k in ("ms", "cc_ms", "plain_ms", "bound_ms", "rows")},
         **{f"qwen_int8_{k}": q_dec["int8"][k]
            for k in ("ms", "cc_ms", "plain_ms", "bound_ms")},
         "phase9_launches": q_launch["paged_flash_decode"],
         "phase11_launches": phase11("paged_flash_decode"),
         **{f"moonshot_{k}": m_dec[k]
            for k in ("ms", "cc_ms", "plain_ms", "bound_ms", "rows")},
         "phase12_launches": m_launch["paged_flash_decode"],
         "phase12_routes": m_routes["paged_flash_decode"],
         "phase13_launches": o_launch["paged_flash_decode"],
         "phase14_launches": g_launch["paged_flash_decode"],
         "phase14_soak_launches": g_soak["paged_flash_decode"],
         "phase15_launches": s_launch["paged_flash_decode"],
         **p18_cols("paged_flash_decode"),
         **tp_cols("paged_flash_decode", pool="bf16"),
         "phase9_launches_by_route_and_group":
             qwen_metrics["decode_group_sizes"],
         "shape": f"{local['L']} lanes, {local['KV']} KV heads x {local['R']} "
                  f"q heads, head_dim {local['hd']}, bf16 pool (int8_*: int8 "
                  f"pool + fp32 scales), {local['rows']} rows, window "
                  f"{local['window']} (kernel_route; cc_ms: the CUDA-core "
                  "kernel on the same inputs; tc_launches: phase 3's launches "
                  "on the tensor-core route, phase7_routes phase 7's by route "
                  "over both pools; exact_max_abs_err: the q = 0, integer-V "
                  "cases; cc_max_abs_err: the CUDA-core kernel's random cases, "
                  "bf16 through the hook and fp32 q through the wrapper; "
                  "host_us / cc_host_us: the wrapper's host time a call on "
                  "bf16 / fp32 q; qwen_* / qwen_int8_*: phase 9's shape, 8 "
                  "KV heads x 6 q heads, head_dim 128, no softcap, global, "
                  "bf16 / int8 pool; phase9_*: phase 9's launches; "
                  "phase11_launches: phase 11's card sessions', fp32 q on "
                  "the CUDA-core route; moonshot_*: phase 12's shape, 16 KV "
                  "heads x 1 q head, head_dim 128, global, bf16 pool; "
                  "phase12_* / phase13_launches: phases 12 and 13's "
                  "launches; phase14_launches / phase14_soak_launches: phase 14's over HTTP, its main traffic and its soak; "
                  "phase15_launches: phase 15's through the one-rank serve "
                  "mesh; phase15_tp2_* / phase15_tp4_*: rank 0's KV-head "
                  "slice of phase 3's bf16 pool, global, the unsharded "
                  "shares pinned)"},
        {"name": "boolean_weight_bwd", "route": "cuda",
         "source": "src/repro_torch/csrc/boolean_weight_bwd.cu",
         "replaces": "src/repro/kernels/boolean_bwd.py:52",
         "phase12_launches": m_launch["boolean_weight_bwd"],
         "phase13_launches": o_launch["boolean_weight_bwd"],
         "phase14_launches": g_launch["boolean_weight_bwd"],
         "phase14_soak_launches": g_soak["boolean_weight_bwd"],
         "launches": train_metrics["launches"]["boolean_weight_bwd"],
         "tc_launches": train_metrics["weight_bwd_routes"]["tensor_cores"],
         "kernel_route": "tensor_cores",
         "max_abs_err": wbwd_err,
         "ms": sum(r["ms"] for r in layer_votes),
         "plain_ms": sum(r["plain_ms"] for r in layer_votes),
         "bound_ms": sum(r["bound_ms"] for r in layer_votes),
         "bound_by": ("bytes" if sum(r["bound_by"] == "bytes" for r in layer_votes)
                      * 2 >= len(layer_votes) else "operations"),
         "library_ms": sum(r["library_ms"] for r in layer_votes),
         "phase16_launches": train_mesh_metrics["launches"][
             "boolean_weight_bwd"],
         "phase16_tc_launches": train_mesh_metrics["tc_launches"],
         **{f"phase16_{r['split']}{r['n']}_{k}": r[k]
            for r in train_mesh_metrics["weight_bwd_slices"]
            for k in ("ms", "bound_ms")},
         "phase16_full_qkv_ms": train_mesh_metrics["weight_bwd_full_qkv_ms"],
         "phase17_launches": dry_metrics["cells"]["train"]["card"][
             "launches_per_call"]["boolean_weight_bwd"] * CELL_TIMED,
         "phase16_full_qkv_bound_ms":
             train_mesh_metrics["weight_bwd_full_qkv_bound_ms"],
         **p18_cols("boolean_weight_bwd"),
         "phase18_train_lm_launches": p18_ex["train_lm"]["launches"][
             "boolean_weight_bwd"],
         "phase18_train_lm_routes": p18_ex["train_lm"]["routes"][
             "boolean_weight_bwd"],
         "phase18_falcon_launches": p18["falcon_train"]["launches"][
             "boolean_weight_bwd"],
         "phase18_falcon_routes": p18["falcon_train"]["weight_bwd_routes"],
         "shape": f"sum over one layer's wq, wk, wv, wo, wg, wu, wd votes at "
                  f"B={WBWD_TOKENS} tokens (one microbatch), bf16 x and z, "
                  "alpha=0 (the tensor-core route; tc_launches: its launches "
                  "in phase 5); phase16_launches / phase16_tc_launches: phase "
                  "16's through the one-rank training mesh; phase16_tp2_* / "
                  "phase16_tp4_*: rank 0's column slices of the wq, wk, wv "
                  "votes at tp 2 / 4 (phase16_full_qkv_*: the full three); "
                  "phase16_dp2_* / phase16_dp4_*: rank 0's row blocks of "
                  "the seven at dp 2 / 4"},
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:87",
         "launches": p7["flash_attention_fwd"],
         "max_abs_err": max(flash_err, qwen_flash_err, moon_flash_err,
                            rank_flash["max_abs_err"]),
         "ms": flash["ms"], "plain_ms": flash["plain_ms"],
         "bound_ms": flash["bound_ms"], "bound_by": flash["bound_by"],
         "library_ms": None, "kernel_route": flash["route"],
         "cc_ms": flash["cc_ms"],
         "sdpa_causal_no_softcap_ms": flash["sdpa_causal_no_softcap_ms"],
         "phase3_routes": metrics["routes"]["flash_attention_fwd"],
         **{f"qwen_{k}": q_flash[k]
            for k in ("ms", "cc_ms", "plain_ms", "bound_ms", "library_ms")},
         "phase9_launches": q_launch["flash_attention_fwd"],
         "phase11_launches": phase11("flash_attention_fwd"),
         "phase9_routes": q_routes["flash_attention_fwd"],
         **{f"moonshot_{k}": m_flash[k]
            for k in ("ms", "cc_ms", "plain_ms", "bound_ms", "library_ms")},
         "phase12_launches": m_launch["flash_attention_fwd"],
         "phase12_routes": m_routes["flash_attention_fwd"],
         "phase13_launches": o_launch["flash_attention_fwd"],
         "phase14_launches": g_launch["flash_attention_fwd"],
         "phase14_soak_launches": g_soak["flash_attention_fwd"],
         "phase15_launches": s_launch["flash_attention_fwd"],
         **p18_cols("flash_attention_fwd"),
         "phase17_launches": dry_metrics["cells"]["prefill"]["card"][
             "launches_per_call"]["flash_attention_fwd"] * CELL_TIMED,
         "phase17_rank_launches": rank_prefill["launches_per_call"][
             "flash_attention_fwd"] * rank_prefill["calls"],
         "phase17_rank_tc_launches": rank_prefill["tc_launches_per_call"]
         * rank_prefill["calls"],
         **{f"phase17_rank_{r['case']}_{k}": r[k] for r in rank_flash["rows"]
            for k in ("S", "ms", "plain_ms", "bound_ms", "max_abs_err")},
         **tp_cols("flash_attention"),
         "shape": f"one layer's cold prefill: {flash['BH']} q heads over "
                  f"{flash['KV']} KV heads, S={flash['S']}, head_dim "
                  f"{flash['hd']}, bf16, softcap 50, window {flash['window']} "
                  "(kernel_route; cc_ms: the CUDA-core kernel on the same "
                  "inputs); launches from phase 7 (bf16 pool), phase3_routes "
                  "phase 3's launches by route; qwen_*: qwen2.5-14b's 1,024-"
                  "token prefill, 48 q over 8 KV heads, head_dim 128, no "
                  "softcap or window, library_ms SDPA (causal), the same "
                  "function there; phase9_*: phase 9's launches; "
                  "phase11_launches: phase 11's card sessions' (fp32, the "
                  "CUDA-core route); moonshot_*: its 1,024-token prefill, "
                  "16 q over 16 KV heads, head_dim 128, library_ms SDPA "
                  "(causal); phase12_* / phase13_launches: phases 12 and "
                  "13's launches; phase14_launches / phase14_soak_launches: phase 14's over HTTP, its main traffic and its soak; "
                  "phase15_launches: phase 15's through the one-rank serve "
                  "mesh; phase15_tp2_* / phase15_tp4_*: rank 0's head slice "
                  "of a 1,024-token prefill, global; phase17_rank_launches: "
                  "prefill_16x16_rank0's (rank 0 of the 16 x 16 prefill_32k "
                  "cell, 2 rows x 1 q head over 1 KV head at 32,768 "
                  "tokens); phase17_rank_global_* / phase17_rank_local_*: "
                  "row 4 at that head-local shape at S tokens (window 4096 "
                  "on local) against its plain version"},
        {"name": "paged_prefix_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/paged_prefix_attention.cu",
         "replaces": "src/repro/kernels/paged_attention.py:335",
         "launches": p7["paged_prefix_attention"], "max_abs_err": pfx_err,
         "ms": pfx["ms"], "plain_ms": pfx["plain_ms"],
         "bound_ms": pfx["bound_ms"], "bound_by": pfx["bound_by"],
         "library_ms": None,
         "kernel_route": pfx["route"], "cc_ms": pfx["cc_ms"],
         "one_share_ms": pfx["one_share_ms"],
         "int8_ms": pfx8["ms"], "int8_cc_ms": pfx8["cc_ms"],
         "int8_one_share_ms": pfx8["one_share_ms"],
         "int8_plain_ms": pfx8["plain_ms"], "int8_bound_ms": pfx8["bound_ms"],
         "phase11_launches": phase11("paged_prefix_attention"),
         **p18_cols("paged_prefix_attention"),
         "phase12_launches": m_launch["paged_prefix_attention"],
         "phase13_launches": o_launch["paged_prefix_attention"],
         "phase14_launches": g_launch["paged_prefix_attention"],
         "phase14_soak_launches": g_soak["paged_prefix_attention"],
         "phase7_routes": {k: v["routes"]["paged_prefix_attention"]
                           for k, v in prefix_metrics.items()},
         "shape": f"one layer's tail prefill: {pfx['H']} q heads over "
                  f"{pfx['KV']} KV heads, a {pfx['T']}-row tail bucket "
                  f"({pfx['length']} real) over {pfx['prefix_rows']} prefix "
                  "rows in 32 scattered pages, head_dim 256, bf16 pool "
                  "(int8_*: int8 pool + fp32 scales; kernel_route; cc_ms: the "
                  "CUDA-core kernel on the same inputs; one_share_ms: the "
                  "tensor-core route with the key window in one share); "
                  "launches from phase "
                  "7 (bf16 pool), phase7_routes its launches by route over "
                  "both pools; phase11_launches: phase 11's card sessions' "
                  "(fp32, the CUDA-core route); phase14_launches / phase14_soak_launches: phase 14's over HTTP, its main traffic and its soak"},
        {"name": "boolean_matmul", "route": "cuda",
         "source": "src/repro_torch/csrc/boolean_matmul.cu",
         "replaces": "src/repro/kernels/boolean_matmul.py:59",
         "phase12_launches": m_launch["boolean_matmul"],
         "phase13_launches": o_launch["boolean_matmul"],
         "phase14_launches": g_launch["boolean_matmul"],
         "phase14_soak_launches": g_soak["boolean_matmul"],
         **gemm_row("boolean_matmul counts", "boolean_matmul"),
         "kernel_route": "tensor_cores",
         "operands_ms": sum(r["operands_ms"] for r in fused),
         "fused_ms": sum(r["ms"] for r in fused),
         "fused_plain_ms": sum(r["plain_ms"] for r in fused),
         "fused_bound_ms": sum(r["bound_ms"] for r in fused),
         "shape": "sum over one VGG-SMALL forward's four +-1-input convs at "
                  "batch 100 as GEMMs (M x K x N: 25600x1152x256, "
                  "25600x2304x256, 6400x2304x512, 6400x4608x512), int32 counts "
                  "(fused_*: the threshold at tau 0 fused, int8 out); "
                  "ms includes operands_ms, the wrapper's transposed copy of "
                  "w; library_ms: torch._int_mm, the faster of w row-major and "
                  "column-major; launches over phase 8"},
        {"name": "packed_xnor_matmul", "route": "cuda",
         "source": "src/repro_torch/csrc/packed_xnor_matmul.cu",
         "replaces": "src/repro/kernels/packed_xnor.py:239",
         "phase12_launches": m_launch["packed_xnor_matmul"],
         "phase13_launches": o_launch["packed_xnor_matmul"],
         "phase14_launches": g_launch["packed_xnor_matmul"],
         "phase14_soak_launches": g_soak["packed_xnor_matmul"],
         **gemm_row("packed_xnor_matmul", "packed_xnor_matmul"),
         "kernel_route": "tensor_cores",
         "b1_ops_per_s": tc_rates["b1"], "int8_ops_per_s": tc_rates["int8"],
         "shape": "the same four GEMMs with both operands bit-packed along K "
                  "(max_abs_err also over the random-pad-bit case); "
                  "bound_ms: operations at the binary tensor cores' rate "
                  "measured by the rate probe (b1_ops_per_s; int8_ops_per_s "
                  "the same probe on int8); library_ms: torch._int_mm on the "
                  "unpacked int8 operands (the faster w layout); launches "
                  "over phase 8"},
    ]
    for row in kernels[:5]:
        row["shape"] += (
            "; phase18_*_launches: phase 18's launches (by route where the "
            "kernel has two) in each example run on the card (quickstart, "
            "serve_lm plain, --packed, --packed --kv-quant) and each "
            "family's smoke training step on the card (train_falcon, "
            "train_moonshot, train_arctic, train_jamba)")
    kernels[2]["shape"] += ("; phase18_train_lm_*: train_lm --full-100m's "
                            "100 steps; phase18_falcon_*: falcon-mamba-7b's "
                            "5 timed training steps at published widths")
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"device": device_line, "seed": args.seed,
                               "build_s": secs, "tensor_core_kernels": ring,
                               "gemv": gemv_rows,
                               "paged_decode": dec_rows,
                               "paged_decode_exact": dec_exact,
                               "weight_bwd": wbwd_rows,
                               "flash_prefill": flash_rows,
                               "paged_prefix": pfx_rows,
                               "uniform_attention": uniform,
                               "bool_gemm": gemm_rows,
                               "tensor_core_ops_per_s": tc_rates,
                               "serve": metrics, "train": train_metrics,
                               "prefix_serve": prefix_metrics,
                               "vision": vision_metrics,
                               "qwen_gemv": qwen_gemv_rows,
                               "qwen_flash_prefill": qwen_flash_rows,
                               "qwen_serve": qwen_metrics,
                               "falcon_gemv": mamba_gemv_rows,
                               "falcon_serve": falcon_metrics,
                               "families": family_metrics,
                               "moonshot_gemv": moon_gemv_rows,
                               "moonshot_flash_prefill": moon_flash_rows,
                               "moonshot_serve": moon_metrics,
                               "overload": overload_metrics,
                               "gateway": gateway_metrics,
                               "serve_mesh": mesh_metrics,
                               "train_mesh": train_mesh_metrics,
                               "dry_run": dry_metrics,
                               "phase18": p18,
                               "phase_wall_s": walls,
                               "phase_start_launch_us": launch_at,
                               "kernels": kernels}, indent=1))
    print(f"details written to {out}")
    print(json.dumps({"kernels": kernels}))
    print(device_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
