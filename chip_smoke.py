#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main paths — pseudo-projection point queries, batched
traversal, sampling and analysis, files, mutation and durability, and the
graph-serving engine and its wire, and the sharded network view, on a
population-scale mixed-mode network, LM serving of every model family
at full width, and LM training at full width — on the card, through the entry
points a user calls (``repro_torch.core.api``, ``repro_torch.core.cli``,
``repro_torch.serve``, ``repro_torch.models.lm_serve``,
``repro_torch.train``), and
fails (non-zero exit) if any phase fails:

1. device   — the card's name and power limit (nvidia-smi);
2. build    — compiles the CUDA kernels (``src/repro_torch/csrc``);
3. kernels  — each CUDA kernel against its plain torch version on seeded
              inputs at the recipe's widths (exact match required), the
              union's count-only output and its wide route (rows past the
              in-block capacity) among them, the padded intersect entry on
              8,191 rows at (Ka, Kb) of 1, 4, 6, 7/5, 32, 33/32, 6/33 and
              512 (rows of all pads, rows without a pad; both its lane-group
              and its warp route), and the CSR-route intersect
              kernel on a 3,000-node layer under a hand-made delta
              overlay (dirty rows, a delta with more and longer rows than
              the base, int32 and int64 indptr, with and without a filter);
4. network  — builds the register-style network with the port's own
              builders: Households / Workplaces / Schools two-mode layers
              (1, 4, 6 memberships per node over n/2.5, n/20, n/400
              groups) plus an Erdős–Rényi layer of mean degree 10 and an
              ``income`` attribute, at 10M nodes by default;
5. main     — getedge / checkedge / getnodealters / getdegree, unfiltered
              and filtered, with launch counts reset just before and read
              just after (intersect_rows must launch exactly once per
              layer and edge call and the padded intersect_count never;
              segmented_union and the count-only segmented_union_count of
              the filtered degree must launch; no union row may take
              torch's sort), recording the rows of the heaviest count-only
              launch;
6. panel    — a Panel layer on the same nodes, register panel memberships
              for the first half of them (1 + geometric, mean 20, cap 512,
              over n/40 groups: ~100M at 10M nodes; cut from all n for the
              smoke's time), its pairs drawn among them, with its own
              launch counts: getedge and
              checkedge x8192 and one checkedge x1,048,576 dyad sample,
              each with its wall time, device busy and idle share, busiest
              device activities and launches a call (intersect_rows once a
              call, intersect_count never);
7. oracle   — 256 seeded queries of each kind (the Panel's pairs too):
              kernel path bit-identical to the port's padded plain path,
              plus a small network against the materialized projection;
8. hubs     — a Workplaces layer whose group sizes are heavy-tailed, as
              employer sizes are: union rows past the in-block kernel's
              capacity must take its wide route (segmented_union_wide,
              union_merge, union_compact launch) and none torch's sort;
              a subsample is checked against the padded plain path;
9. traversal — on the same network, with launch counts reset just before
              and read just after: a k-hop over all 4 layers (512
              sources, k=2, frontier cap 256, 128 alters per node), a
              one-mode k-hop over ``Random`` (1,024 sources, k=3), ego
              networks (512 egos, k=2) and component counts (unfiltered
              and ``income > median``); the frontier kernel and the
              union's wide route must launch, no frontier row may take the
              plain path and no union row torch's sort. 64 sources of
              each k-hop and ego batch must be bit-identical to the plain
              path on the card, and a small network's components and
              k-hops must equal scipy's on its materialized projection.
              Each call prints its wall time, device-idle share and the
              device activities that took most of its busy time;
10. sampling — on the same network, with launch counts reset just before
              and read just after: walk fleets through ``api.walkbatch``
              (65,536 starts x 4 walkers x 40 steps over the 4 layers with
              layer weights and the income > median filter; 262,144
              Households walkers x 40 steps), neighborhood samples (fanout
              [10, 5], 8,192 seeds by walk steps, 1,024 by alter unions),
              the four estimators, degreedist with and without the filter,
              getdensity, projected_degree, a BFS over all layers,
              shortestpath, countcomponents, memoryreport, describenet,
              subnetwork on a seeded 1 % of the nodes, the processing calls
              on a 1M-node directed valued layer and a TemporalNetwork of
              three yearly 100k-node snapshots; each call's wall time,
              device-idle share and busiest activities. The threefry kernels
              (threefry_bits, randint, csr_row_sample) and segmented_union
              must launch; each threefry kernel must equal its plain
              version at every launch shape of the phase; the first 1,024
              starts' rows of each fleet and sample must equal the port's
              CPU path on a host copy of the network (a walker whose layer
              choice on the card differed from the CPU's, by the log of the
              Gumbel draw, is excused and counted; more than 1 in 10^4 of
              65,536 compared walkers fails); BFS levels must equal k-hop
              groups, and a small network's BFS distances and shortest
              paths scipy's;
11. storage — on the same network: ``savefile(compress=False)``, then
              ``loadfile`` with and without ``mmap`` (wall time, GB/s;
              every buffer must equal the network's), each load's peak
              host-RSS growth read alone in a fresh interpreter (it must
              reach the bytes the load allocates on the host, the
              ``indptr`` mirrors and the staging buffer, and the mmap
              load's must stay under the file's size); batches of
              register changes through
              ``api.addedges`` / ``deleteedges`` / ``setnodeattr`` (10,000
              household and 10,000 workplace moves, 1,000 memberships in
              100 new workplaces, 100,000 new and 10,000 ended Random
              ties, 10,000 school joins, which cross the compaction ratio,
              1,000 memberships in 100 new schools past id 65,535, 10,000
              incomes), each batch with its wall time, device busy and
              idle, delta nnz, overlay ratio, bytes uploaded and whether it
              compacted; getedge and checkedge x8192 on the 4 layers (half
              the sources on touched rows), getnodealters x2048, the
              filtered getdegree x8192 and a Workplaces walk fleet of
              65,536 starts x 40 steps on the overlays, with launch counts
              reset just before and read just after (intersect_rows,
              segmented_union and csr_row_sample must launch), each equal
              to the same query on ``Network.compacted()`` (timed), 256
              queries a kind equal to the padded plain path, and the three
              kernels equal to their plain versions on the overlays
              ``overlay_update`` wrote (an int32 delta over a uint16 base,
              a member CSR grown past its base's rows); a ``DurableStore``
              fed the same changes (create, apply, close, ``recovernet``:
              equal to the directly mutated network, compacted) and its
              WAL cut inside the last record (recovered with torn bytes to
              the state before it), on ``STORE_NODES`` nodes; and JSON-
              mode CLI scripts through ``Session()`` on the card: one loads
              the saved file (mmap), applies the same changes and asks
              checkedge, getnodealters, the filtered getdegree and khop on
              inputs of the overlay queries above (its network must equal
              the directly mutated one, its outputs those queries', and
              frontier_compact must launch), the other runs savestore,
              recovernet and wallog on ``STORE_NODES`` nodes;
12. serving — the graph-serving engine on the same network (counts reset
              before, read after; the oracle's launches not counted): the
              JAX package's serving trace (benchmarks/run.py, seed 17) of
              10,000 requests, getedge on Workplaces, alters and k-hop on
              Households + Random, walks on Random, income > median as the
              filter. (a) ``api.serve`` and a profiled engine run against a
              loop of single calls: rates, cache hits, coalesced
              duplicates, batches and launches per kind, device busy, idle
              and host-to-device share; every result bit-identical, 256 of
              each trace kind equal to the plain paths; (b)
              ``api.servenet`` with 8 client sessions: capacity from a
              closed loop of 2,000 requests, then an open loop at 0.8 of it
              under the reference's fault burst (p50/p90/p99, faults,
              idempotent replays), every wire result equal to (a)'s, no
              error, ready afterwards, every CUDA launch and copy of the
              window on the pump thread; (c) 16 mutations interleaved,
              scoped against global invalidation, equal results, scoped
              misses at most global. intersect_rows, segmented_union,
              frontier_compact and csr_row_sample must launch, no sort
              rows; at most 180 s;
13. sharded — the sharded network view (``core/sharded.py``) on the same
              network, counts reset before and read after each part: (a)
              ``shard_network`` at 2, 8 and 4 shards, one at a time (wall,
              device bytes added, host-mirror bytes); (b) at 4 shards the
              main path's getedge x8192 on each two-mode layer and on
              Random, checkedge_any x8192, getnodealters x2048, getdegree
              x8192 unfiltered and income > median, the k-hop over all
              layers (512 sources, k 2, caps 256/128) and the component
              labels, each equal to the unsharded port's bit for bit, with
              its wall against the unsharded call's, device busy and idle
              and launches a call (intersect_count, frontier_compact and
              segmented_union must launch, no union row torch's sort); (c)
              ``ShardedTwoMode`` on Households at 4 shards: the edge value
              x8192 equal to the unsharded layer's, the walk step (65,536
              walkers x 4 steps) equal to itself with the plain draws, each
              move to a co-member; (d) ``GraphServeEngine(shards=4)`` on the
              serving trace: every record equal to the unsharded engine's,
              requests/s of both, a profiled run with the pump started
              (every launch and copy under the pump's ids), one add_edges of
              4 Random ties through the pump by ``reshard_deltas`` and a
              getedge of them; (e) ``benchmarks/torch_sharded_perf.py`` at
              its default (120,000 nodes, hub degree 800): k-hop walls at
              1/2/4/8 shards, the 1-over-4 ratio and the candidate widths.
              At most 150 s;
14. lm      — LM serving at full width, bf16, through
              ``ServeEngine.generate``: qwen3-1.7b (28 layers, d_model
              2048) and mamba2-130m (24 layers, d_model 768), each with
              weights drawn from a seeded generator, serving 8 requests of
              2,048 seeded prompt tokens and 64 new tokens, greedy and at
              temperature 0.8, with launch counts reset just before and
              read just after (flash_attention, rmsnorm and ssd_scan must
              launch; flash_attention_copies, flash_attention_fma and
              ssd_scan_fma must stay 0: bf16 attention and the SSD scan at
              mamba2's width take the tensor-core routes; both SSD counts
              are printed). Prints per call the wall time, tokens/s, prefill ms
              and decode ms per step, the device-idle share and busiest
              device activities of one profiled prefill and decode step,
              and max_memory_allocated. Checks each LM kernel against its
              plain version evaluated in f32 at every shape the phase
              launched, element by element within a limit scaled to the
              reference (and that the limit rejects a zeroed output and
              the reference rounded to 5 bits), the greedy first tokens
              against the argmax of ``Model.apply``, and, in an f32 copy
              of each model, prefill + 8 decode steps against
              ``Model.apply`` (2 requests, 256-token prompts);
15. lm_families — every other model family at full width, bf16, through
              ``ServeEngine.generate``, each model freed before the next:
              llama4-scout-17b-a16e (MoE, 16 experts top-1 and a shared
              expert; 8 of its 48 layers, the cut printed), recurrentgemma-9b
              (38 layers: 12 x (RG-LRU, RG-LRU, local attention) + 2 RG-LRU,
              window 2,048, so decode wraps its ring from the first step),
              internvl2-26b and musicgen-large (4 codebooks: prompts of
              2,048 x 4 tokens), each 16 of its 48 layers for the smoke's
              time (the cut printed); the lm phase's traffic,
              one warm-up and one timed call a kind; counts reset before and
              read after (rmsnorm must launch for all four, flash_attention
              for the three unwindowed ones and never for recurrentgemma,
              rglru_scan once an RG-LRU layer a prefill, 26, and never in
              decode; flash_attention_copies and flash_attention_fma stay 0).
              Prints per config the wall, tokens/s, prefill ms and decode ms
              a step, a profiled prefill's and decode step's idle share and
              busiest activities, max_memory_allocated; for scout the tokens
              each expert takes and the share dropped at prefill and decode;
              for internvl2 one prefill with 256 seeded patch embeddings
              ahead of the prompt and 8 decode steps at offset positions.
              Checks each kernel against its plain version in f32 at every
              launched shape with the lm phase's limits and planted faults
              (rglru_scan also from a seeded nonzero state), the route each
              rmsnorm width took, greedy first tokens against ``Model.apply``
              (a choice a codebook for audio), and f32 copies 2 layers deep
              (recurrentgemma: one group and the tail, 5; MoE at capacity
              n_experts; internvl2 with its prefix): prefill 256 + 8 decode
              steps against ``Model.apply``. At most 150 s;
16. train   — training on the card through ``repro_torch.train``:
              qwen3-1.7b at full width and depth (28 layers, bf16, remat by
              layer), 4 AdamW steps of ``Trainer.train_step`` on walk-corpus
              batches (``repro_torch.data.pipeline.WalkCorpus``) of this
              network, 4 walks of 2,048 nodes over its four layers, drawn
              before the steps; counts reset before and read after
              (rmsnorm, flash_attention and their backward kernels
              rmsnorm_bwd and flash_attention_bwd must launch, the latter on
              its tensor-core route from the forward's o, o_lo and lse; the
              copy and FMA-route counts stay 0); each step's loss (finite, the last
              below the first), ms and tokens/s, one more step timed in parts
              (forward, backward, optimizer), max_memory_allocated. Then at 2
              of the 28 layers (full width and vocabulary) 4 steps without a
              break against 2 through ``Trainer.fit`` (a checkpoint), a new
              trainer that restores it and takes 2 more: parameters and master
              weights equal bit for bit; ``launch/serve.py``'s
              ``restore_params`` serves 8 greedy tokens from that checkpoint,
              the first equal to ``Model.apply``'s argmax. The backward
              kernels against their plain versions (f32 autograd) on the
              inputs the main path gave them, each element within 2^-6 of its
              reference plus 2^-10 of the reference's largest (planted faults
              rejected; ``rglru_scan_bwd`` also bit for bit equal to its
              plain loop), and in f32 at a small shape within 1e-4. Before
              the checks, the scan families (``train_scans``, its seconds
              printed beside its 35 s budget): mamba2-130m (24 layers) and
              recurrentgemma-9b cut to 5 of 38 layers (one (R, R, A) group
              and the (R, R) tail; all 38 with AdamW's state pass the card's
              memory, and 8 ran out of it in a step; its cross-entropy in
              chunks of 2,048 tokens), full width, bf16, 4 AdamW steps each
              of 4 x 2,048 synthetic tokens (``launch/train.py --data
              synthetic``); loss
              finite and falling, the forward and backward scan kernels
              launched (``ssd_scan_bwd_states``, ``ssd_scan_bwd``: the SSD
              backward's tensor-core route, its FMA route's counts and
              ``ssd_scan_bwd_copies`` 0; ``rglru_scan_bwd``), the scans'
              plain versions called 0 times in the steps, ms a step in
              parts, tokens/s, peak GB. Every trainer gets the policy of
              the one card it trains on (``make_policy(make_host_mesh(1),
              cfg)``), as ``launch/train.py`` passes it. At most 150 s;
17. dryrun  — ``repro_torch.launch.dryrun.run_cell`` for all 40 cells of
              the (arch x shape) matrix on both production meshes (16x16
              and 2x16x16 cards) on the meta device: per card the
              parameter, optimizer and cache or carry bytes, whether they
              fit this card's memory, a step's analytic HBM bytes and
              FLOPs; 32 cells a mesh ok and 8 skipped, no error;
18. timing  — each kernel, its plain version and its bound at the heaviest
              shape its phase launched (the CSR-route intersect kernel on
              the Panel's dyads and on the main path's heaviest call, cold,
              by CUDA events with the L2 flushed before each launch; the
              padded intersect entry at the main path's [8192, 6]; the
              union also on the main path's
              recorded rows, written out and counted only, and its wide
              route on the traversal's recorded heaviest merge): the device
              time of one call from torch.profiler, summed over the kernels
              the call launches, or where the profiler lost them all its
              CUDA-event time per call, marked so; for the LM kernels the
              one torch call that computes the same function (SDPA,
              ``F.rms_norm``) as a yardstick the port never calls;
              plain and library calls timed with CUDA events over
              back-to-back calls. RMSNorm runs on a rotation of buffers
              larger than the L2 (cold rows, as in a prefill), at the
              hidden and the q-norm shape. The threefry kernels at the
              sampling phase's heaviest launch of each, their hashes'
              integer instructions bound at 4 warp instructions a clock
              an SM at the card's maximum SM clock; csr_row_sample cold
              with its sector count, and cold and on the card alone (the
              card spun ahead of the host) at that launch and the phase's
              three most frequent launch shapes, each with its launch
              count. A kernel or library time under
              its bound fails the phase. ``rglru_scan`` cold (CUDA events,
              the L2 flushed) at the lm_families phase's heaviest launch,
              bound by the bytes it moves, no library call. The backward
              kernels cold at the train phase's heaviest recorded shape
              (rmsnorm_bwd also at the q-norm width, 128), with the library's
              backward (SDPA's, ``F.rms_norm``'s autograd) cold beside them
              (both also printed with the card spun ahead of the host: the
              device time alone, the gap the wrapper's host work);
              flash's time is every launch of its backward from the saved
              forward outputs, the Dd pass included, its bound the larger of
              2.5 times the forward's causal flops at the bf16 tensor-core
              peak and its bytes (q, k, v, dO, o, o_lo and lse read, dq, dk,
              dv written); the flash forward under grad (o_lo and lse
              written) is printed beside the ordinary call at the lm phase's
              shape; rmsnorm's bound is the bytes of x, w and dy read and dx
              written; ``ssd_scan_bwd`` and
              ``rglru_scan_bwd`` with no library call (none computes either
              gradient), the SSD's bound the larger of its bytes and 2.5
              times the chunked products at the backward's own chunk at the
              bf16 tensor-core peak, the RG-LRU's its bytes; each backward kernel launched
              twice more on the same inputs, which must give the same bits.
              The ``launches`` of each record add the sharded, lm_families
              and train phases' counts to its own phase's.

Its last lines are the ``kernels`` JSON record and then
``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
repository's ``src/repro_torch`` beside it, it exits non-zero and prints
no result.
"""

from __future__ import annotations

import collections
import json
import math
import statistics
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# the card's rates, kept once for the port: H100 SXM5 datasheet (dense
# bf16 tensor-core FLOP/s, HBM3 bytes/s)
from repro_torch.perf.analytic import HBM_BW as HBM_BYTES_PER_S  # noqa: E402
from repro_torch.perf.analytic import PEAK_FLOPS as BF16_TENSOR_OPS_PER_S  # noqa: E402

# Memberships drawn per node per layer; group spaces scale with n. At 10M
# nodes: 10M households memberships over 4M groups, 40M workplaces over
# 500k, 60M schools over 25k -> ~110M memberships.
LAYER_RECIPE = (
    # (name, per_node, nodes_per_group)
    ("Households", 1, 2.5),
    ("Workplaces", 4, 20.0),
    ("Schools", 6, 400.0),
)
CHUNK = 4_000_000  # COO rows per streamed chunk
ER_MEAN_DEGREE = 10.0
# The repository's population scale (10M nodes, ~110M memberships). A run
# that must be cut lowers N_NODES only; the recipe per node stays.
N_NODES = 10_000_000
SEED = 0

# Hub phase: the Workplaces recipe (4 memberships per node over n/20
# groups) with group popularity drawn from a Pareto law of tail index
# 1.05, the firm-size law of Axtell (Science 293:1818, 2001), and the
# largest group held to 0.5 % of the nodes.
HUB_TAIL = 1.05
HUB_MAX_SHARE = 0.005
HUB_QUERIES = 1024
HUB_ORACLE_QUERIES = 64

# Panel phase: register panel memberships, one per employer and year over a
# few decades of workplace-by-year spells: per node 1 + a geometric count,
# mean 20 (numpy's geometric on {1, 2, ...}), capped at 512, over n/20
# groups drawn uniformly -- the intersect kernel's design regime, "mean ~20
# memberships/node" (src/repro/kernels/intersect.py:6-11). Random pairs then
# fall ~11 % into the 8-wide bucket of max(deg u, deg v), ~54 % into the 32,
# ~35 % into the 128 and ~0.3 % above. A run that must be cut lowers
# PANEL_NODES (the nodes given memberships, among whom the Panel's pairs
# are drawn) only; the law per node stays. Cut to half the nodes: with all
# 10M (200M memberships) the whole smoke took 1,179.9-1,203.5 s of its
# 1,200 on slow hosts (qwen3 decode 90-96 ms a step against 43 on others),
# and the layer's build and pairs 196.9 s against 95.4 at half, on one
# NVIDIA H100 80GB HBM3 host (benchmarks/torch_smoke_cuts.py).
PANEL_MEAN = 20.0
PANEL_CAP = 512
PANEL_NODES_PER_GROUP = 20.0
PANEL_NODES = N_NODES // 2
DYAD_PAIRS = 1 << 20  # one dyad sample, as threadleR's sampling analyses draw
PAIR_CHUNK = 1 << 16  # pairs drawn at a time by panel_pairs
L2_FLUSH_BYTES = 256 << 20  # written between cold launches (the L2 is 50 MB)

SCALAR_OPS_PER_S = 67e12  # H100 SXM non-tensor peak (float32 table entry)
# 32-bit integer instructions: an SM issues at most 4 warp instructions a
# clock (one a scheduler), 32 lanes each; the float32 entry above counts a
# fused multiply-add as two flops, so it is twice the integer rate
INT_LANE_OPS_PER_CLOCK = 4 * 32
# of which the integer ALU pipe (adds, logic, shifts, compares) takes 16
# lanes a clock on each of the 4 schedulers; IMAD goes to the FMA pipe
ALU_LANE_OPS_PER_CLOCK = 4 * 16

POINT_PAIRS = 8192
ALTERS_NODES = 2048
DEGREE_NODES = 8192
MAX_ALTERS = 4096
ORACLE_QUERIES = 256
REPEATS = 5

# Traversal phase. The register k-hop takes benchmarks/run.py:469-472's
# threadleR traversal settings (k=2, per-hop frontier cap 256, per-node
# gather cap 128) with the sources cut from 1,000 to 512: hop 2 expands up
# to 65,536 distinct nodes, and the Schools gather for them holds several
# int32 copies of 65,536 x 8 x 2,611 entries (~20 GB peak).
KHOP_SOURCES = 512
KHOP_K = 2
KHOP_MAX_FRONTIER = 256
KHOP_NODE_CAP = 128
ONEMODE_SOURCES = 1024
ONEMODE_K = 3
EGO_NODES = 512
EGO_K = 2
EGO_MAX_ALTERS = 256
TRAVERSAL_SUBSAMPLE = 64
TRAVERSAL_REPEATS = 3
SMALL_NODES = 3000

# Sampling phase, on the same network: threadleR's sampling analyses. A
# walk fleet of 65,536 starts x 4 walkers x 40 steps over the 4 layers
# (layer weights, the income > median filter) and a one-layer fleet of
# 262,144 Households walkers; GraphSAGE-style neighborhood samples
# (fanout [10, 5]) from 8,192 seeds by walk steps and 1,024 by alter
# unions; the four estimators (1,048,576 uniform nodes; 8,192 walkers x 64
# steps). The first PREFIX_STARTS starts of each fleet and sample are held
# against the port's CPU path; CHOICE_WALKERS walkers' layer choices are
# compared, at most CHOICE_TOL of them may differ (the card's log).
FLEET_STARTS = 65_536
FLEET_WALKERS = 4
FLEET_STEPS = 40
FLEET_WEIGHTS = (1.0, 2.0, 2.0, 1.0)  # Households, Workplaces, Schools, Random
ONE_LAYER_WALKERS = 262_144
NS_FANOUT = (10, 5)
NS_WALK_SEEDS = 8192
NS_ALTERS_SEEDS = 1024
NS_ALTERS_PREFIX = 128
EST_NODES = 1 << 20
EST_WALKERS = 8192
EST_STEPS = 64
PROJ_DEGREE_NODES = 8192
PREFIX_STARTS = 1024
CHOICE_WALKERS = 65_536
CHOICE_TOL = 1e-4
BFS_CHECK_FRONTIER = 32_768
SUBNET_SHARE = 0.01
# processing runs on a smaller directed, valued layer: symmetrize sorts
# and dedups twice the edges in host numpy, a cost that grows with the
# edges past what the phase can spend at Random's 50M. Cut from 1M to
# 500,000 nodes after a whole smoke of 1,158.6 s of its 1,200 on a slow
# host, where symmetrize, dichotomize and filter_edges took 36.7 s at 1M
# (NVIDIA H100 80GB HBM3, 700.00 W)
PROCESSING_NODES = 500_000
PROCESSING_DEGREE = 10.0
TEMPORAL_NODES = 100_000
TEMPORAL_YEARS = (2019, 2020, 2021)
TEMPORAL_PAIRS = 256
TEMPORAL_WALKERS = 1024

# Storage phase, on the same network: files, batches of register changes
# through the api, queries on the overlays against compacted(), the durable
# store and the CLI. The batches: 10,000 household moves and 10,000
# workplace moves (each a delete and an add), 1,000 memberships in 100 new
# workplaces, 100,000 new and 10,000 ended Random ties, 10,000 school
# joins, 1,000 memberships in 100 new schools numbered from 65,536 (the
# id space passes uint16: an int32 delta over Schools' uint16 base), and
# 10,000 new incomes. They are batches of these sizes, not a measured
# span of a register's churn. STORE_NODES sizes the network the durable
# store and the CLI's savestore and recovernet run on (the same recipe
# and changes): cut to 500,000 nodes. At 10M the store's zlib snapshot
# of 1.4 GB took 103.9 s to write and 68.6 s to inflate and replay, and the
# CLI's own savestore and recovernet 134.2 s, on an NVIDIA H100 80GB HBM3
# host, where the phase has about 240 s; at 1M the store's part took
# 78.3 s against 40.5 at 500,000 on one such host
# (benchmarks/torch_smoke_cuts.py), in smokes of 1,179.9-1,203.5 s of
# their 1,200 on slow hosts.
REG_MOVES = 10_000
REG_NEW_GROUPS = 100
REG_NEW_MEMBERS = 1_000
REG_RANDOM_ADDS = 100_000
REG_RANDOM_DELETES = 10_000
REG_SCHOOL_JOINS = 10_000
REG_FIRST_NEW_SCHOOL = 1 << 16
REG_INCOME_UPDATES = 10_000
STORE_NODES = 500_000
STORAGE_WALK_STARTS = 65_536
STORAGE_WALK_STEPS = 40
STORAGE_REPEATS = 3
CLI_QUERIES = 8

# Serving phase (benchmarks/torch_serve_slo.py): the JAX package's
# serving trace (benchmarks/run.py::build_serve_trace, seed 17) of
# SERVE_REQUESTS on the register network: getedge on Workplaces, alters
# and k-hop on Households + Random, walks on Random, income > median as
# the filter. (a) the engine (SERVE_CACHE entries) against a loop of
# single calls on every SERVE_LOOP_STRIDE-th request (the wire's results
# are held against the engine's for every request); (b) the wire:
# SERVE_CLIENTS sessions, capacity from a closed loop of the first
# SERVE_CAPACITY_REQUESTS, then an open loop at SERVE_LOAD of it with the
# reference's fault burst; (c) SERVE_MUTATIONS interleaved mutations (8
# add_edges of 4 Random ties, 8 aux rewrites of 4 nodes; the reference's
# 64 cut to 16, a Random batch costing 1.4-2.4 s of host numpy at 10M),
# scoped against global invalidation.
SERVE_REQUESTS = 10_000
SERVE_SEED = 17
SERVE_CACHE = 4096
# the loop of single calls runs every 8th request (cut): all 10,000 took
# 169.4 s on an NVIDIA H100 80GB HBM3 at 700 W, past the phase's 180 s;
# every 4th until the train phase brought the smoke to 1,111 s of its
# 1,200 on a slow host (this phase 171.0 s there, its loop 41.6 s of it)
SERVE_LOOP_STRIDE = 8
SERVE_CLIENTS = 8
SERVE_CAPACITY_REQUESTS = 2_000
SERVE_LOAD = 0.8
SERVE_DEADLINE_MS = 2000.0
SERVE_MUTATIONS = 16
SERVE_AUX_SEED = 23
SERVE_MUTATION_SEED = 41
SERVE_TARGET_RATIO = 5.0  # the reference's engine-vs-loop target, printed
SERVE_P99_BUDGET_MS = 50.0  # the reference's p99 budget, printed
SERVE_PHASE_LIMIT_S = 180.0
SERVE_KERNELS = ("intersect_rows", "segmented_union", "frontier_compact",
                 "csr_row_sample")
# the CUDA kernels each graph launch count may launch, one of them once a
# count: a profiled window that holds fewer of these kernels' device
# events than the counts rose by lost events
GRAPH_KERNEL_SYMBOLS = {
    "intersect_rows": ("intersect_rows_kernel",),
    "intersect_count": ("intersect_count_kernel", "intersect_count_kernel_lanes"),
    "segmented_union": ("segmented_union_kernel",),
    "segmented_union_count": ("segmented_union_kernel",),
    "segmented_union_wide": ("segmented_union_kernel",),
    "union_merge": ("union_merge_kernel",),
    "union_compact": ("union_compact_kernel",),
    "frontier_compact": ("frontier_kernel",),
    "csr_row_sample": ("csr_row_sample_kernel",),
    "threefry_bits": ("threefry_bits_kernel",),
    "randint": ("randint_kernel",),
}
# (b) sends one attribute write over the wire half way through the open
# loop, on a column no request of the trace reads
SERVE_PROBE_ATTR = "probe"
SERVE_PROBE_NODES = (0, 1, 2, 3)

# sharded: the sharded network view (core/sharded.py) on the same network
SHARD_COUNTS = (2, 8, 4)  # built one at a time; the last one is kept
SHARDS = 4
SHARDED_REPEATS = 3
SHARDED_WALKERS = 65_536
SHARDED_WALK_STEPS = 4
SHARDED_WALK_LAYER = "Households"
SHARDED_PHASE_LIMIT_S = 150.0
SHARDED_KERNELS = ("intersect_count", "frontier_compact", "segmented_union")
SHARDED_BENCH_NODES = 120_000  # benchmarks/torch_sharded_perf.py's default
SHARDED_BENCH_HUB = 800
SHARDED_MUTATION_TIES = 4

# LM phase: both configurations at full width in bf16 (depth not cut),
# random weights from SEED. Traffic: LM_REQUESTS prompts of LM_PROMPT
# seeded tokens, LM_NEW new tokens, greedy and at LM_TEMPERATURE.
LM_ARCHS = ("qwen3-1.7b", "mamba2-130m")
LM_REQUESTS = 8
LM_PROMPT = 2048
LM_NEW = 64
LM_MAX_SEQ = LM_PROMPT + LM_NEW
LM_TEMPERATURE = 0.8
# decode against the full forward, in an f32 copy of each model
LM_CHECK_REQUESTS = 2
LM_CHECK_PROMPT = 256
LM_CHECK_STEPS = 8
# f32 logits of decode vs Model.apply: the same function, with the decode
# attention and SSD recurrence in plain torch and the prefill through the
# kernels, sums over d_model 2048 and 28 layers taken in another order
# (3.8e-5 and 1.2e-5 measured on the H100; logits std 0.9 and 0.55)
LM_F32_ATOL = 2e-4
# bf16 kernels against their plain versions evaluated in f32 on the same
# inputs (the upcast is exact): each kernel computes in f32 and rounds its
# output to bf16 once, within 2^-8 of the value (8 significant bits), so an
# element may differ by LM_REL_TOL of its own size, plus LM_FLOOR_TOL of the
# reference's largest value for f32 sums taken in another order
LM_REL_TOL = 2.0**-7
LM_FLOOR_TOL = 2.0**-12
# planted faults the same check must reject at every launched shape: a
# zeroed output, and the reference rounded to LM_FAULT_BITS significant bits
LM_FAULT_BITS = 5
# timed generate calls per call kind, after one warm-up: 1 since the train
# phase brought the smoke to 1,059-1,111 s of its 1,200 (3 before)
LM_REPEATS = 1

# lm_families phase: the other families at full width in bf16, random
# weights from SEED, the lm phase's traffic (audio: LM_PROMPT steps of its 4
# codebooks). Depth cuts (LM_FAMILY_LAYERS, printed with the reason):
# llama4-scout to 8 of its 48 layers, since all 48 take 215.5 GB in bf16,
# past the card's 80 GB; internvl2 and musicgen to 16 of 48 for the smoke's
# time: with all 48 the phase took 150.6 s of its 150 s on the H100, twice
# (their decode is host-bound, 93-120 ms a step), and with 24 the whole
# smoke took 1,059 s of its 1,200 once the train phase came. The
# f32 check copies are 2 layers deep,
# recurrentgemma's one (R, R, A) group and the (R, R) tail.
LM_FAMILY_ARCHS = ("llama4-scout-17b-a16e", "recurrentgemma-9b", "internvl2-26b",
                   "musicgen-large")
LM_FAMILY_LAYERS = {"llama4-scout-17b-a16e": 8, "internvl2-26b": 16,
                    "musicgen-large": 16}
LM_FAMILY_TIME_CUT = ("the smoke's time: with all 48 layers of internvl2 and "
                      "musicgen the phase took 150.6 s of its 150 s on the H100 "
                      "(decode host-bound, 93-120 ms a step), and with 24 the "
                      "smoke 1,059 s of its 1,200 once training came")
LM_CARD_BYTES = 80e9  # the H100's device memory
LM_FAMILY_CHECK_LAYERS = {"recurrentgemma-9b": 5}
LM_FAMILY_CHECK_DEFAULT_LAYERS = 2
LM_FAMILY_REPEATS = 1  # timed generate calls per call kind, after one warm-up
LM_FAMILY_PREFILLS = 1  # prefills timed apart, greedy kind only
LM_FAMILY_PREFIX_STEPS = 8  # internvl2: decode steps after its patch prefix
LM_FAMILY_PHASE_LIMIT_S = 150.0


def log(msg: str) -> None:
    print(msg, flush=True)


def membership_chunks(n_nodes: int, per_node: int, n_groups: int, seed: int):
    """Yield (node_ids, group_ids) chunks: per_node draws for each node."""
    rng = np.random.default_rng(seed)
    rows_per_chunk = max(CHUNK // per_node, 1)
    for start in range(0, n_nodes, rows_per_chunk):
        stop = min(start + rows_per_chunk, n_nodes)
        nodes = np.repeat(np.arange(start, stop, dtype=np.int64), per_node)
        groups = rng.integers(0, n_groups, nodes.size, dtype=np.int64)
        yield nodes, groups


def build_network(n_nodes: int, seed: int, device):
    """The register-style mixed-mode network, built with the port's builders."""
    from repro_torch.core import api
    from repro_torch.core.layers import two_mode_from_membership_chunks

    net = api.createnetwork(api.createnodeset(n_nodes, device=device))
    for i, (name, per_node, npg) in enumerate(LAYER_RECIPE):
        n_groups = max(int(n_nodes / npg), 1)
        t0 = time.perf_counter()
        layer = two_mode_from_membership_chunks(
            n_nodes, n_groups,
            membership_chunks(n_nodes, per_node, n_groups, seed + 100 + i),
            device=device,
        )
        net = net.with_layer(name, layer)
        log(f"network: {name}: {layer.n_memberships} memberships over "
            f"{n_groups} groups, max {layer.max_memberships} per node, "
            f"largest group {layer.max_hyperedge_size}, "
            f"{time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    net = api.generate(api.addlayer(net, "Random", 1), "Random", type="er",
                       p=ER_MEAN_DEGREE / n_nodes, seed=seed + 7)
    log(f"network: Random: {net.layer('Random').n_edges} edges, "
        f"{time.perf_counter() - t0:.3f} s")
    income = np.random.default_rng(seed + 8).integers(
        0, 100_000, n_nodes, dtype=np.int64
    )
    net = api.setnodeattr(net, "income", np.arange(n_nodes), income, kind="int")
    return net, int(np.median(income))


def device_line(fields: str = "name,power.limit") -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0].strip()


CLOCK_FIELDS = "clocks.sm,clocks.max.sm,power.draw,temperature.gpu"


def sync():
    import torch

    torch.cuda.synchronize()


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` launches, after a warm-up."""
    import torch

    fn()
    sync()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    sync()
    return start.elapsed_time(end) / iters


PROFILER_WINDOWS = 3


class ProfilerLostEvents(RuntimeError):
    """The profiler delivered no device event in any of its windows."""


def device_events(prof) -> dict:
    """A profile's device activities: {name: [events, microseconds]}."""
    import torch

    acts = collections.defaultdict(lambda: [0, 0.0])
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            acts[e.name][0] += 1
            acts[e.name][1] += e.time_range.elapsed_us()
    return acts


def device_activity(fn, iters: int) -> dict:
    """Every kernel, copy and fill that ``iters`` calls of ``fn`` put on
    the card, after a warm-up (torch.profiler/CUPTI): {name: [events,
    microseconds]}.

    Late in this long process the profiler sometimes delivers only part
    of a window's device events, or none. An empty window is profiled
    again, up to ``PROFILER_WINDOWS`` windows; if all are empty this
    raises, so a time reported as device time always is one. A busy time
    summed from a window that lost events is a lower bound.
    """
    from torch.profiler import ProfilerActivity, profile

    fn()
    sync()
    for _ in range(PROFILER_WINDOWS):
        with warnings.catch_warnings():
            # each profile() is one cycle; its "clears events" notice is moot
            warnings.filterwarnings("ignore", message=".*Profiler clears events")
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(iters):
                    fn()
                sync()
        acts = device_events(prof)
        if sum(us for _, us in acts.values()) > 0:
            return acts
    raise ProfilerLostEvents(
        f"torch.profiler recorded no device activity in {PROFILER_WINDOWS} windows")


def rotating(call, inputs: list, keep: int):
    """A call of ``call`` on each argument list of ``inputs`` in turn,
    holding its last ``keep`` outputs, so that back-to-back launches read
    and write ``len(inputs)`` and ``keep`` distinct buffers: timed on
    buffers that together exceed the 50 MB L2, each launch finds its row
    cold, as a prefill's norms do."""
    state = {"i": 0, "outs": collections.deque(maxlen=keep)}

    def run():
        i = state["i"]
        state["i"] = (i + 1) % len(inputs)
        out = call(*inputs[i])
        state["outs"].append(out)
        return out

    return run


def int_ops_per_s(sms: int, max_sm_mhz: float) -> float:
    """The card's peak rate of integer instructions, counted a lane each:
    ``sms`` SMs issuing INT_LANE_OPS_PER_CLOCK a clock at ``max_sm_mhz``."""
    return sms * INT_LANE_OPS_PER_CLOCK * max_sm_mhz * 1e6


def card_int_ops_per_s() -> float:
    """``int_ops_per_s`` of the card: its SM count, and its maximum SM
    clock as nvidia-smi reads it (``clocks.max.sm``, MHz)."""
    import torch

    mhz = float(device_line("clocks.max.sm").split()[0])
    return int_ops_per_s(torch.cuda.get_device_properties(0).multi_processor_count, mhz)


def check_readings(rec: dict) -> dict:
    """Refuses a ``kernels`` record whose kernel ``ms`` or ``library_ms``
    reads under its ``bound_ms``: no card does the work in less than its
    bound, so such a reading is a fault of the timing. Returns ``rec``."""
    bound = rec["bound_ms"]
    for key in ("ms", "library_ms"):
        t = rec[key]
        if t is not None and t < bound:
            raise AssertionError(
                f"{rec['name']}: {key} {t} ms reads under its bound {bound} ms")
    return rec


def host_median_ms(fn, repeats: int = REPEATS) -> tuple[float, object]:
    """Median wall time of ``fn`` (which ends in a host copy) after a warm-up."""
    out = fn()
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        out = fn()
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), out


def max_abs_err(got, want) -> int:
    got = got.cpu().to(dtype=want.dtype)
    want = want.cpu()
    if got.shape != want.shape:
        raise AssertionError(f"shape {tuple(got.shape)} vs {tuple(want.shape)}")
    if got.numel() == 0:
        return 0
    return int((got.long() - want.long()).abs().max())


# ---------------------------------------------------------------------------
# Seeded kernel inputs
# ---------------------------------------------------------------------------


def sorted_rows(rng, rows: int, width: int, universe: int, device):
    """Sorted unique SENTINEL-padded membership-like rows on the device."""
    import torch

    from repro_torch.core.csr import SENTINEL

    vals = torch.from_numpy(rng.integers(0, universe, (rows, width), dtype=np.int32))
    lens = torch.from_numpy(rng.integers(0, width + 1, rows))
    vals = torch.sort(vals, dim=1).values
    dup = torch.zeros_like(vals, dtype=torch.bool)
    dup[:, 1:] = vals[:, 1:] == vals[:, :-1]
    keep = (~dup) & (torch.arange(width)[None, :] < lens[:, None])
    vals = torch.where(keep, vals, int(SENTINEL))
    return torch.sort(vals, dim=1).values.contiguous().to(device)


# the padded intersect entry's checks: (Ka, Kb) on both sides of its
# narrow route's 32-entry edge, the sharded path's 1, 4 and 6 and the
# Panel cap's 512 among them
INTERSECT_COUNT_WIDTHS = ((1, 1), (4, 4), (6, 6), (7, 5), (32, 32), (33, 32),
                          (6, 33), (512, 512))


def count_rows(rng, ka: int, kb: int, device):
    """(a, b) for the padded intersect entry: POINT_PAIRS - 1 rows (no
    multiple of a block's), sorted and SENTINEL-padded over ids below
    2 max(Ka, Kb); every 7th row of a and every 11th of b all pads, the
    last 64 rows of both without a pad."""
    import torch

    from repro_torch.core.csr import SENTINEL

    rows, universe = POINT_PAIRS - 1, 2 * max(ka, kb)
    out = []
    for k, every in ((ka, 7), (kb, 11)):
        x = sorted_rows(rng, rows, k, universe, device)
        x[::every] = int(SENTINEL)
        full = np.sort(np.stack([rng.choice(universe, k, replace=False)
                                 for _ in range(64)]), axis=1)
        x[-64:] = torch.from_numpy(full.astype(np.int32)).to(device)
        out.append(x)
    return out


def flat_rows(rng, rows: int, width: int, device, universe: int | None = None):
    """Unsorted rows with duplicates and SENTINEL holes, like a gathered
    co-member block; ids below ``universe`` (default width // 3)."""
    import torch

    from repro_torch.core.csr import SENTINEL

    universe = max(width // 3, 2) if universe is None else universe
    flat = rng.integers(0, universe, (rows, width), dtype=np.int32)
    flat[rng.random((rows, width)) < 0.25] = SENTINEL
    return torch.from_numpy(flat).to(device)


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------


def phase_kernels(device, seed: int) -> dict:
    """Each CUDA kernel against its plain version at the recipe's widths."""
    import torch

    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.frontier import MAX_CAND
    from repro_torch.kernels.segmented_union import MAX_FLAT

    rng = np.random.default_rng(seed + 1)
    worst = {"intersect_count": 0, "intersect_rows": 0, "segmented_union": 0,
             "segmented_union_count": 0, "segmented_union_wide": 0,
             "frontier_compact": 0}
    for ka, kb in INTERSECT_COUNT_WIDTHS:
        a, b = count_rows(rng, ka, kb, device)
        err = max_abs_err(ops.intersect_count(a, b), ref.intersect_count_ref(a, b))
        worst["intersect_count"] = max(worst["intersect_count"], err)
        log(f"kernels: intersect_count [{a.shape[0]},{ka}]x[{b.shape[0]},{kb}] (all-pad, "
            f"no-pad and random rows): max_abs_err {err}")
    worst["intersect_rows"] = overlay_rows_check(device, seed)
    for width, rows, max_out in ((1 * 32, 2048, MAX_ALTERS),
                                 (4 * 256, 2048, MAX_ALTERS),
                                 (6 * 2048, 1024, MAX_ALTERS),
                                 (4 * MAX_ALTERS, 1024, MAX_ALTERS),
                                 (MAX_FLAT, 256, MAX_FLAT)):
        flat = flat_rows(rng, rows, width, device)
        gv, gm = ops.segmented_union(flat, max_out)
        wv, wm = ref.segmented_union_ref(flat, max_out)
        err = max(max_abs_err(gv, wv), max_abs_err(gm.int(), wm.int()))
        worst["segmented_union"] = max(worst["segmented_union"], err)
        cerr = max_abs_err(ops.segmented_union_count(flat),
                           ref.segmented_union_count_ref(flat))
        worst["segmented_union_count"] = max(worst["segmented_union_count"], cerr)
        log(f"kernels: segmented_union width {width} rows {rows} max_out "
            f"{max_out}: max_abs_err {err}, count-only {cerr}")
    # the wide route: a traversal merge row (4 layers x a 16,384 cap) and a
    # hub row (4 memberships x a 50,466-member group), ids up to 10^7
    for width, rows, max_out in ((4 * 16384, 256, 16384), (4 * 50466, 64, MAX_ALTERS)):
        flat = flat_rows(rng, rows, width, device, universe=N_NODES)
        gv, gm = ops.segmented_union(flat, max_out)
        wv, wm = ref.segmented_union_ref(flat, max_out)
        err = max(max_abs_err(gv, wv), max_abs_err(gm.int(), wm.int()),
                  max_abs_err(ops.segmented_union_count(flat),
                              ref.segmented_union_count_ref(flat)))
        worst["segmented_union_wide"] = max(worst["segmented_union_wide"], err)
        log(f"kernels: segmented_union (wide route) width {width} rows {rows} "
            f"max_out {max_out} and count-only: max_abs_err {err}")
    # candidate widths of the traversal's chunks; visited widths of hop 1
    # (the source column), a 256-cap hop 2 and a 4096-cap hop 3
    for width in (32, 1024, 8192, MAX_CAND):
        for kv in (1, 257, 8193):
            cand = flat_rows(rng, 256, width, device)
            visited = flat_rows(rng, 256, kv, device, universe=max(width // 3, 2))
            err = 0
            for max_out in (256, width):
                gv, gm = ops.frontier_compact(cand, visited, max_out)
                wv, wm = ref.frontier_search_ref(
                    cand, torch.sort(visited, dim=-1).values, max_out)
                err = max(err, max_abs_err(gv, wv), max_abs_err(gm.int(), wm.int()))
            worst["frontier_compact"] = max(worst["frontier_compact"], err)
            log(f"kernels: frontier_compact width {width} visited {kv} rows 256 "
                f"max_out 256 and {width}: max_abs_err {err}")
    if any(worst.values()):
        raise AssertionError(f"kernels disagree with their plain versions: {worst}")
    return worst


def overlay_layer(device, seed: int, indptr64: bool):
    """A SMALL_NODES-node two-mode layer (0-8 memberships a node over 500
    groups: uint16 ids, int32 indptr, or int64 with ``indptr64``) under a
    hand-made delta overlay: 300 dirty rows and 20 rows past the base, each
    holding 0-150 ids (wider than any base row), stored as int32 ids over
    int64 indptr."""
    import dataclasses

    import torch

    from repro_torch.core.csr import csr_from_arrays
    from repro_torch.core.layers import two_mode_from_memberships
    from repro_torch.core.overlay import DeltaOverlay, eff_max_degree

    rng = np.random.default_rng(seed + 13)
    n, h, extra = SMALL_NODES, 500, 20
    nodes = np.repeat(np.arange(n), rng.integers(0, 9, n))
    layer = two_mode_from_memberships(n, h, nodes, rng.integers(0, h, nodes.size),
                                      device=device)
    memb = layer.memb
    if indptr64:
        memb = csr_from_arrays(memb.indptr_host.astype(np.int64),
                               memb.indices.cpu().numpy(), None, n, h, device)
    dirty = np.zeros(n + extra, bool)
    dirty[rng.choice(n, 300, replace=False)] = True
    dirty[n:] = True
    lengths = np.where(dirty, rng.choice([0, 2, 9, 40, 150], n + extra), 0)
    indptr = np.zeros(n + extra + 1, np.int64)
    indptr[1:] = np.cumsum(lengths)
    ids = np.concatenate([np.sort(rng.choice(h, k, replace=False)) for k in lengths])
    ov = DeltaOverlay(
        delta=csr_from_arrays(indptr, ids.astype(np.int32), None, n + extra, h,
                              device),
        dirty=torch.from_numpy(dirty).to(device),
        base_shadowed=int(np.diff(memb.indptr_host)[dirty[:n]].sum()),
        dirty_host=dirty,
    )
    return dataclasses.replace(layer, memb=memb, memb_ov=ov,
                               max_memberships=max(eff_max_degree(memb, ov), 1))


def overlay_rows_check(device, seed: int) -> int:
    """The CSR-route intersect kernel against its plain version (the
    degree-bucketed route) on ``overlay_layer`` with int32 and int64 base
    indptr, over ids -3 .. n + 25, with and without a node filter shorter
    than the id range; then the api on it against the padded plain path.
    Returns the largest difference (0 required)."""
    import torch

    from repro_torch.core import api
    from repro_torch.core.dispatch import DEFAULT_BUCKET_WIDTHS
    from repro_torch.kernels import ops, ref

    rng = np.random.default_rng(seed + 14)
    worst = 0
    for indptr64 in (False, True):
        layer = overlay_layer(device, seed, indptr64)
        ids = rng.integers(-3, SMALL_NODES + 26, (2, 4096)).astype(np.int32)
        u, v = (torch.from_numpy(x).to(device) for x in ids)
        nf = torch.from_numpy(rng.random(SMALL_NODES - 7) < 0.7).to(device)
        for f in (None, nf):
            got = ops.intersect_rows(layer.memb, layer.memb_ov, u, v, f,
                                     widths=DEFAULT_BUCKET_WIDTHS)
            want = ref.intersect_rows_ref(layer.memb, layer.memb_ov, u, v, f,
                                          DEFAULT_BUCKET_WIDTHS)
            worst = max(worst, max_abs_err(got, want))
        net = api.createnetwork(api.createnodeset(SMALL_NODES, device=device)
                                ).with_layer("ov", layer)
        a, b = rng.integers(0, SMALL_NODES, (2, 1024))
        want = layer.edge_value_padded(torch.from_numpy(a).to(device),
                                       torch.from_numpy(b).to(device)).cpu()
        worst = max(worst, int((api.getedge(net, "ov", a, b) != want).sum()))
        log(f"kernels: intersect_rows on a {SMALL_NODES}-node layer under a "
            f"hand-made overlay ({int(layer.memb_ov.dirty_host.sum())} dirty rows, "
            f"delta {layer.memb_ov.delta.n_rows} rows of int32 ids over int64 "
            f"indptr; base {layer.memb.indices.dtype} ids over "
            f"{layer.memb.indptr.dtype} indptr), 4096 pairs, unfiltered and "
            f"filtered, and the api on 1024 pairs against the padded plain path: "
            f"max_abs_err {worst}")
    return worst


def pair_ids(layer, n: int, count: int, rng, device, u=None):
    """Seeded (u, v) pairs; in the first half v is a co-member of u in one
    of u's groups, so those pairs share at least one group. ``u`` given
    replaces the drawn sources (the draws stay the same)."""
    import torch

    drawn = rng.integers(0, n, count)
    u = drawn if u is None else np.asarray(u, dtype=np.int64)
    v = rng.integers(0, n, count)
    half = count // 2
    he, hm = layer.memberships(torch.from_numpy(u[:half].astype(np.int32)).to(device))
    pick = torch.from_numpy(rng.integers(0, 1 << 30, half)).to(device)
    k = hm.sum(dim=1).clamp(min=1)
    col = (pick % k).unsqueeze(1)
    h = torch.gather(he, 1, col)[:, 0]
    size = layer.hyperedge_sizes()[torch.where(hm[:, 0], h, 0).long()].clamp(min=1)
    mem, mm = layer.member_rows(torch.where(hm[:, 0], h, 0), layer.max_hyperedge_size)
    pick = torch.from_numpy(rng.integers(0, 1 << 30, half)).to(device)
    w = torch.gather(mem, 1, (pick % size).unsqueeze(1).long())[:, 0]
    ok = (hm[:, 0] & mm[:, 0]).cpu().numpy()
    v[:half] = np.where(ok, w.cpu().numpy(), v[:half])
    return u, v


def edge_pairs(net, rng, device) -> dict:
    """The main path's POINT_PAIRS pairs (``pair_ids``) of each layer of
    LAYER_RECIPE, drawn in its order from ``rng``."""
    return {name: pair_ids(net.layer(name), net.n_nodes, POINT_PAIRS, rng, device)
            for name, _, _ in LAYER_RECIPE}


def panel_membership_chunks(n_nodes: int, n_groups: int, seed: int):
    """Yield (node_ids, group_ids) chunks of the Panel recipe: node i draws
    min(Geometric(1 / PANEL_MEAN), PANEL_CAP) groups, uniformly."""
    rng = np.random.default_rng(seed)
    rows_per_chunk = max(int(CHUNK / PANEL_MEAN), 1)
    for start in range(0, n_nodes, rows_per_chunk):
        stop = min(start + rows_per_chunk, n_nodes)
        per = np.minimum(rng.geometric(1.0 / PANEL_MEAN, stop - start), PANEL_CAP)
        nodes = np.repeat(np.arange(start, stop, dtype=np.int64), per)
        yield nodes, rng.integers(0, n_groups, nodes.size, dtype=np.int64)


def build_panel(n_nodes: int, seed: int, device):
    """The Panel layer over ``n_nodes`` nodes, of which the first
    PANEL_NODES hold memberships, one group for every 20 of them."""
    from repro_torch.core.layers import two_mode_from_membership_chunks

    members = min(PANEL_NODES, n_nodes)
    n_groups = max(int(members / PANEL_NODES_PER_GROUP), 1)
    t0 = time.perf_counter()
    layer = two_mode_from_membership_chunks(
        n_nodes, n_groups, panel_membership_chunks(members, n_groups, seed + 300),
        device=device,
    )
    cut = ("no cut" if members >= n_nodes else
           f"cut: {members} of {n_nodes} nodes hold memberships, law per node kept")
    log(f"panel: Panel: {layer.n_memberships} memberships over {n_groups} groups, "
        f"mean {layer.n_memberships / members:.2f} / max {layer.max_memberships} "
        f"per node ({cut}), largest group {layer.max_hyperedge_size}, ids "
        f"{layer.memb.indices.dtype}, indptr {layer.memb.indptr.dtype}, "
        f"{layer.memb.nbytes + layer.members.nbytes} device bytes, built in "
        f"{time.perf_counter() - t0:.3f} s")
    return layer


def panel_pairs(layer, n: int, seed: int, device) -> tuple:
    """The Panel calls' ids among its first ``n`` nodes (those holding
    memberships): POINT_PAIRS pairs, then DYAD_PAIRS dyads drawn PAIR_CHUNK
    at a time (``pair_ids``: half of each draw co-members)."""
    rng = np.random.default_rng(seed + 12)
    point = pair_ids(layer, n, POINT_PAIRS, rng, device)
    parts = [pair_ids(layer, n, min(PAIR_CHUNK, DYAD_PAIRS - i), rng, device)
             for i in range(0, DYAD_PAIRS, PAIR_CHUNK)]
    return point, tuple(np.concatenate(side) for side in zip(*parts))


class Counted:
    """``fn`` with a count of its calls."""

    def __init__(self, fn):
        self.fn, self.calls = fn, 0

    def __call__(self):
        self.calls += 1
        return self.fn()


def edge_launches(label: str, before: dict, calls: int) -> str:
    """Fails unless, since ``before``, the CSR-route intersect kernel
    launched once for each of ``calls`` edge calls on one two-mode layer
    and the padded-row entry never."""
    from repro_torch.kernels import build

    rows = build.launch_counts["intersect_rows"] - before.get("intersect_rows", 0)
    padded = build.launch_counts["intersect_count"] - before.get("intersect_count", 0)
    if rows != calls or padded:
        raise AssertionError(
            f"{label}: intersect_rows launched {rows} times in {calls} calls and "
            f"intersect_count {padded} times (want {calls} and 0)")
    return f"intersect_rows x{rows / calls:g} a call"


def busy_share(fn, wall_ms: float, top: int = 0) -> str:
    """Device busy time of one profiled call and the idle share of the
    median call; ``top`` > 0 adds the device activities that took most of
    the busy time (name, launches, ms). A display, not a check: where the
    profiler of this long process delivers no event of a short call in
    any window, the busy time reads "not measured"."""
    try:
        acts = device_activity(fn, 1)
    except ProfilerLostEvents as err:
        return f"device busy not measured ({err})"
    busy = sum(us for _, us in acts.values()) / 1e3
    out = (f"device busy {busy:.3f} ms, idle "
           f"{max(0.0, 1.0 - busy / wall_ms) * 100:.1f}% of the median call")
    if top:
        ranked = sorted(acts.items(), key=lambda kv: -kv[1][1])[:top]
        out += "; most busy: " + ", ".join(
            f"{name[:72]} x{n} {us / 1e3:.3f} ms" for name, (n, us) in ranked)
    return out


def main_path(net, median_income: int, seed: int, device) -> tuple[dict, dict]:
    """The point-query path through the api, timed per call. Returns the
    median latencies and the ids each call was given."""
    from repro_torch.core import api

    from repro_torch.kernels import build

    rng = np.random.default_rng(seed + 2)
    n = net.n_nodes
    sel = api.selectnodes(net, "income", ">", median_income)
    log(f"main: filter income > {median_income} keeps {sel.count} nodes")
    results, queries = {}, {}
    for name, (u, v) in edge_pairs(net, rng, device).items():
        queries[f"getedge/{name}"] = (u, v)
        before = collections.Counter(build.launch_counts)
        getedge = Counted(lambda: api.getedge(net, name, u, v))
        checkedge = Counted(lambda: api.checkedge(net, name, u, v).cpu())
        ms, vals = host_median_ms(getedge)
        results[f"getedge/{name}"] = ms
        ms2, hits = host_median_ms(checkedge)
        results[f"checkedge/{name}"] = ms2
        busy = busy_share(checkedge, ms2, top=4)
        launched = edge_launches(f"main {name}", before,
                                 getedge.calls + checkedge.calls)
        check_edge_values(f"main {name}", vals, hits, POINT_PAIRS)
        log(f"main: getedge {name} x{POINT_PAIRS}: median {ms:.3f} ms, "
            f"{int((vals > 0).sum())} pairs share a group (max "
            f"{float(vals.max()):.0f}); checkedge median {ms2:.3f} ms, {busy}; "
            f"{launched}")
    u = rng.integers(0, n, ALTERS_NODES)
    queries["getnodealters"] = u
    for label, filt in (("unfiltered", None), ("filtered", sel)):
        call = lambda: api.getnodealters(net, u, max_alters=MAX_ALTERS, filter=filt)  # noqa: E731
        ms, (vals, mask) = host_median_ms(call)
        results[f"getnodealters/{label}"] = ms
        if vals.shape != (ALTERS_NODES, MAX_ALTERS):
            raise AssertionError(f"getnodealters shape {tuple(vals.shape)}")
        log(f"main: getnodealters {label} x{ALTERS_NODES} over "
            f"{len(net.layers)} layers: median {ms:.3f} ms, mean "
            f"{float(mask.sum(dim=1).float().mean()):.1f} alters per node, "
            + busy_share(call, ms))
    u = rng.integers(0, n, DEGREE_NODES)
    queries["getdegree"] = u
    for label, filt in (("unfiltered", None), ("filtered", sel)):
        call = lambda: api.getdegree(net, u, filter=filt)  # noqa: E731
        ms, deg = host_median_ms(call)
        results[f"getdegree/{label}"] = ms
        if deg.shape != (DEGREE_NODES,) or (deg < 0).any():
            raise AssertionError("getdegree out of range")
        log(f"main: getdegree {label} x{DEGREE_NODES}: median {ms:.3f} ms, "
            f"mean degree {float(deg.mean()):.2f}, " + busy_share(call, ms))
    return results, queries


def check_edge_values(label: str, vals, hits, count: int) -> None:
    """getedge values of ``count`` pairs (half co-members first) and the
    checkedge answers on the same pairs: in range and consistent."""
    if not (vals.shape == (count,) and bool((vals >= 0).all())
            and bool(((vals > 0) == hits).all())
            and int((vals[: count // 2] > 0).sum()) > count // 4):
        raise AssertionError(f"getedge/checkedge on {label} out of range")


def phase_panel(net, seed: int, device) -> dict:
    """GetEdgeValue / CheckEdge on the Panel layer (PANEL_* recipe, on the
    main network's nodes) through the api, with the launch counts set to 0
    just before and read just after: getedge and checkedge x POINT_PAIRS
    and one checkedge x DYAD_PAIRS dyad sample, each printed with its
    median wall time, device busy time and idle share, busiest device
    activities and launches a call. The CSR-route kernel must launch once
    a call, the padded-row entry never. Returns the layer, its network, the
    dyads, the counts and the dyad call's busy line."""
    from repro_torch.core import api
    from repro_torch.kernels import build

    layer = build_panel(net.n_nodes, seed, device)
    panel = api.createnetwork(net.nodeset).with_layer("Panel", layer)
    (u, v), (du, dv) = panel_pairs(layer, min(PANEL_NODES, net.n_nodes), seed, device)
    calls = {
        f"getedge x{POINT_PAIRS}": Counted(lambda: api.getedge(panel, "Panel", u, v)),
        f"checkedge x{POINT_PAIRS}":
            Counted(lambda: api.checkedge(panel, "Panel", u, v).cpu()),
        f"checkedge x{DYAD_PAIRS} (dyad sample)":
            Counted(lambda: api.checkedge(panel, "Panel", du, dv).cpu()),
    }
    build.launch_counts.clear()
    outs, busy = {}, ""
    for name, call in calls.items():
        before = collections.Counter(build.launch_counts)
        ms, outs[name] = host_median_ms(call)
        busy = busy_share(call, ms, top=4)
        log(f"panel: {name}: median {ms:.3f} ms, {busy}; "
            + edge_launches(f"panel {name}", before, call.calls))
    sync()
    launches = dict(build.launch_counts)
    log(f"panel: launch counts {json.dumps(launches, sort_keys=True)}")
    vals, hits, dyads = outs.values()
    check_edge_values("Panel", vals, hits, POINT_PAIRS)
    if dyads.shape != (DYAD_PAIRS,) or int(dyads.sum()) < DYAD_PAIRS // 4:
        raise AssertionError("checkedge on the Panel dyads out of range")
    log(f"panel: getedge x{POINT_PAIRS}: {int((vals > 0).sum())} pairs share a "
        f"group (max {float(vals.max()):.0f}); dyads: {int(dyads.sum())} of "
        f"{DYAD_PAIRS} share one")
    return {"layer": layer, "net": panel, "dyads": (du, dv), "launches": launches,
            "dyad_busy": busy}


def phase_oracle(net, panel_net, median_income: int, seed: int, device) -> None:
    """Kernel path vs the port's padded plain path, bit for bit (the Panel
    layer's pairs among them)."""
    import torch

    from repro_torch.core import api
    from repro_torch.kernels import ref

    rng = np.random.default_rng(seed + 3)
    n = net.n_nodes
    sel = api.selectnodes(net, "income", ">", median_income)
    nf = sel.device_mask(device)
    q = ORACLE_QUERIES
    bad = []
    for name, net_of in [(name, net) for name, _, _ in LAYER_RECIPE] + [
            ("Panel", panel_net)]:
        layer = net_of.layer(name)
        u, v = pair_ids(layer, n, q, rng, device)
        ut = torch.from_numpy(u.astype(np.int32)).to(device)
        vt = torch.from_numpy(v.astype(np.int32)).to(device)
        want = layer.edge_value_padded(ut, vt).cpu()
        got = api.getedge(net_of, name, u, v)
        if not torch.equal(got, want):
            bad.append(f"getedge/{name}")
        if not torch.equal(api.checkedge(net_of, name, u, v).cpu(), want > 0):
            bad.append(f"checkedge/{name}")
    u = rng.integers(0, n, q)
    ut = torch.from_numpy(u.astype(np.int32)).to(device)
    for label, filt, mask in (("unfiltered", None, None), ("filtered", sel, nf)):
        parts = []
        for layer in net.layers:
            if layer.mode == 2:
                parts.append(layer.node_alters_padded(ut, MAX_ALTERS, node_filter=mask)[0])
            else:
                parts.append(layer.node_alters(ut, MAX_ALTERS, node_filter=mask)[0])
        want, _ = ref.segmented_union_ref(torch.cat(parts, dim=-1), MAX_ALTERS)
        got, _ = api.getnodealters(net, u, max_alters=MAX_ALTERS, filter=filt)
        if not torch.equal(got, want.cpu()):
            bad.append(f"getnodealters/{label}")
        deg = api.getdegree(net, u, filter=filt)
        if mask is None:
            want_deg = sum(layer.degrees()[ut.long()].cpu().long() for layer in net.layers)
        else:
            want_deg = sum(layer.filtered_degree_padded(ut, mask).cpu().long()
                           for layer in net.layers)
        if not np.array_equal(deg, want_deg.numpy()):
            bad.append(f"getdegree/{label}")
    small_projection_check(device, seed, bad)
    if bad:
        raise AssertionError(f"kernel path differs from the plain path: {bad}")
    log(f"oracle: {q} queries per kind (getedge/checkedge on "
        f"{len(LAYER_RECIPE)} layers and Panel, getnodealters and getdegree "
        f"unfiltered and filtered): bit-identical to the padded plain path")


def small_projection_check(device, seed: int, bad: list) -> None:
    """A small network on the card against the materialized projection."""
    import torch

    from repro_torch.core import api
    from repro_torch.core.projection import project_two_mode

    net = api.createnetwork(api.createnodeset(3000, device=device))
    net = api.generate(net, "wk", type="2mode", h=60, a=3, seed=seed + 4)
    layer = net.layer("wk")
    proj = project_two_mode(layer)
    rng = np.random.default_rng(seed + 5)
    u = rng.integers(0, 3000, 1000)
    v = rng.integers(0, 3000, 1000)
    ut = torch.from_numpy(u.astype(np.int32)).to(device)
    vt = torch.from_numpy(v.astype(np.int32)).to(device)
    if not torch.equal(api.getedge(net, "wk", u, v), proj.edge_value(ut, vt).cpu()):
        bad.append("small/getedge-vs-projection")
    full = proj.max_degree()
    got, _ = api.getnodealters(net, u[:200], max_alters=full)
    want, _ = proj.node_alters(ut[:200], full)
    if not torch.equal(got, want.cpu()):
        bad.append("small/getnodealters-vs-projection")


def main_path_shapes(net, queries: dict) -> dict:
    """The heaviest launch shape of each kernel on the main path, from the
    dispatcher's own plan for the ids the main path was given."""
    from repro_torch.core import dispatch
    from repro_torch.core.overlay import eff_host_degrees

    widths = []
    for name, _, _ in LAYER_RECIPE:
        layer = net.layer(name)
        u, v = queries[f"getedge/{name}"]
        deg = np.maximum(eff_host_degrees(layer.memb, layer.memb_ov, u),
                         eff_host_degrees(layer.memb, layer.memb_ov, v))
        for idx, w in dispatch.plan_buckets(deg, layer.max_memberships):
            r = dispatch._pow2_rows(idx.size)
            widths.append((r * w, r, w))
    _, rows, width = max(widths)
    u = queries["getdegree"]
    flats = []
    for name, _, _ in LAYER_RECIPE:
        layer = net.layer(name)
        deg = eff_host_degrees(layer.memb, layer.memb_ov, u)
        for idx, wm in dispatch.plan_buckets(deg, layer.max_memberships):
            wn = dispatch._second_hop_width(layer, u, idx, dispatch.DEFAULT_BUCKET_WIDTHS)
            r = dispatch._pow2_rows(idx.size)
            flats.append((r * wm * wn, r, wm * wn, name))
    _, urows, uwidth, uname = max(flats)
    return {"intersect": (rows, width), "union": (urows, uwidth, uname)}


def phase_timing(net, queries: dict, seed: int, launches: dict, worst: dict,
                 counted, panel: dict, traversal: dict, sampling: dict, lm: dict,
                 device) -> list:
    """Kernel, plain version and bound at the heaviest shape each kernel's
    phase launched: the main path's for the padded intersect entry and the
    union (and its recorded rows for the count-only union, ``counted``), the
    Panel phase's dyads for the CSR-route intersect kernel
    (``rows_timing``), the traversal phase's (its recorded inputs) for the
    frontier kernel and the union's wide route, the lm phase's (its
    recorded inputs) for the LM kernels. What each time means is set out in
    ``kernel_record``.
    """
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.segmented_union import MAX_FLAT

    shapes = main_path_shapes(net, queries)
    rng = np.random.default_rng(seed + 6)
    records = []

    rows, width = shapes["intersect"]
    a = sorted_rows(rng, rows, width, 4 * width, device)
    b = sorted_rows(rng, rows, width, 4 * width, device)
    err = max_abs_err(ops.intersect_count(a, b), ref.intersect_count_ref(a, b))
    kernel = lambda: ops.intersect_count(a, b)  # noqa: E731
    plain = lambda: ref.intersect_count_ref(a, b)  # noqa: E731
    nbytes = 4 * rows * (2 * width) + 4 * rows
    valid = int((a != 2**31 - 1).sum())
    ops_count = valid * max(math.log2(width), 1.0)
    records.append(kernel_record(
        "intersect_count", ("intersect_count_kernel",),
        "src/repro_torch/csrc/intersect.cu",
        "src/repro/kernels/intersect.py:64", launches.get("intersect_count", 0),
        max(err, worst["intersect_count"]), kernel, plain, 50, nbytes,
        ops_count, f"[{rows},{width}]x[{rows},{width}]",
        library_none="no torch call counts a per-row intersection",
    ))

    records.append(rows_timing(net, queries, panel, worst, device))

    rows, width, layer_name = shapes["union"]
    if width > MAX_FLAT:
        raise AssertionError(f"{layer_name} union rows {width} wide exceed {MAX_FLAT}")
    flat = flat_rows(rng, rows, width, device)
    gv, gm = ops.segmented_union(flat, width)
    wv, wm = ref.segmented_union_ref(flat, width)
    err = max(max_abs_err(gv, wv), max_abs_err(gm.int(), wm.int()))
    kernel = lambda: ops.segmented_union(flat, width)  # noqa: E731
    plain = lambda: ref.segmented_union_ref(flat, width)  # noqa: E731
    nbytes = 4 * rows * width + 4 * rows * width
    ops_count = rows * width * max(math.log2(width), 1.0)
    records.append(kernel_record(
        "segmented_union", ("segmented_union_kernel",),
        "src/repro_torch/csrc/segmented_union.cu",
        "src/repro/kernels/segmented_union.py:94", launches["segmented_union"],
        max(err, worst["segmented_union"]), kernel, plain, 5, nbytes,
        ops_count, f"[{rows},{width}]->[{rows},{width}] ({layer_name} filtered degree)",
        library_none="torch.unique has no per-row form",
    ))

    # the main path's own rows: the heaviest count-only launch of its
    # filtered getdegree, recorded; the rows written out (printed beside
    # the synthetic record above), then the count alone (a record)
    _, (flat,), _ = counted
    rows, width = flat.shape
    ops_count = rows * width * max(math.log2(width), 1.0)
    gv, gm = ops.segmented_union(flat, width)
    wv, wm = ref.segmented_union_ref(flat, width)
    err = max(max_abs_err(gv, wv), max_abs_err(gm.int(), wm.int()))
    if err:
        raise AssertionError("segmented_union disagrees on the main path's rows")
    kernel_record(
        "segmented_union", ("segmented_union_kernel",),
        "src/repro_torch/csrc/segmented_union.cu",
        "src/repro/kernels/segmented_union.py:94", launches["segmented_union"],
        err, lambda: ops.segmented_union(flat, width),
        lambda: ref.segmented_union_ref(flat, width), 5, 8 * rows * width,
        ops_count, f"[{rows},{width}]->[{rows},{width}] (the main path's "
        "recorded rows)", library_none="torch.unique has no per-row form",
    )
    err = max_abs_err(ops.segmented_union_count(flat),
                      ref.segmented_union_count_ref(flat))
    records.append(kernel_record(
        "segmented_union_count", ("segmented_union_kernel",),
        "src/repro_torch/csrc/segmented_union.cu",
        "src/repro/kernels/segmented_union.py:94",
        launches["segmented_union_count"],
        max(err, worst["segmented_union_count"]),
        lambda: ops.segmented_union_count(flat),
        lambda: ref.segmented_union_count_ref(flat), 5,
        4 * rows * width + 4 * rows, ops_count,
        f"[{rows},{width}]->[{rows}] (the main path's recorded filtered-degree "
        f"rows, count only)", library_none="torch.unique has no per-row form",
    ))

    # the wide route at the traversal's heaviest merge, on its recorded rows
    _, (flat, max_out), call = traversal["wide"]
    rows, width = flat.shape
    tiles, _, chunk = ops.union_wide_plan(rows, width, max_out)
    chunks = -(-rows // chunk)
    levels = max(tiles - 1, 0).bit_length()
    if max_out is None:
        kernel = lambda: ops.union_wide(flat, None)  # noqa: E731
        plain = lambda: ref.segmented_union_count_ref(flat)  # noqa: E731
        err = max_abs_err(kernel(), plain())
    else:
        kernel = lambda: ops.union_wide(flat, max_out)  # noqa: E731
        plain = lambda: ref.segmented_union_ref(flat, max_out)[0]  # noqa: E731
        err = max_abs_err(kernel(), plain())
    symbols = (("segmented_union_kernel", chunks),
               ("union_merge_kernel", chunks * levels),
               ("union_compact_kernel", chunks))
    records.append(kernel_record(
        "segmented_union_wide", tuple(sym for sym in symbols if sym[1]),
        "src/repro_torch/csrc/segmented_union.cu",
        "src/repro/kernels/segmented_union.py:94",
        traversal["launches"]["segmented_union_wide"],
        max(err, worst["segmented_union_wide"]), kernel, plain, 3,
        4 * rows * width + 4 * rows * (max_out or 1),
        rows * width * max(math.log2(width), 1.0),
        f"[{rows},{width}]->[{rows},{max_out}] ({tiles} tiles, {levels} merge "
        f"levels, {chunks} row chunks; {call})",
        library_none="torch.unique has no per-row form",
    ))

    _, (cand, visited, max_out), call = traversal["heaviest"]
    rows, kc = cand.shape
    kv = visited.shape[1]
    gv, gm = ops.frontier_compact(cand, visited, max_out, visited_sorted=True)
    wv, wm = ref.frontier_search_ref(cand, visited, max_out)
    err = max(max_abs_err(gv, wv), max_abs_err(gm.int(), wm.int()))
    kernel = lambda: ops.frontier_compact(  # noqa: E731
        cand, visited, max_out, visited_sorted=True)
    plain = lambda: ref.frontier_search_ref(cand, visited, max_out)  # noqa: E731
    nbytes = 4 * rows * (kc + kv) + 4 * rows * max_out
    # a sort of each candidate row and a search of the visited row per slot
    ops_count = rows * kc * (max(math.log2(kc), 1.0) + max(math.log2(kv), 1.0))
    records.append(kernel_record(
        "frontier_compact", ("frontier_kernel",),
        "src/repro_torch/csrc/frontier.cu", "src/repro/kernels/frontier.py:105",
        traversal["launches"]["frontier_compact"],
        max(err, worst["frontier_compact"]), kernel, plain, 20, nbytes,
        ops_count, f"[{rows},{kc}] vs [{rows},{kv}] -> [{rows},{max_out}] ({call})",
        library_none="no torch call dedups per row against a second row",
    ))
    records += draw_timing(sampling)
    for r in records:
        if r["max_abs_err"] != 0:
            raise AssertionError(f"{r['name']} disagrees at the main-path shape")
    records += lm_timing(lm)
    return records


HOST_AHEAD_CYCLES = 2_000_000  # about 1 ms of the H100's 1.98 GHz clock


def cold_ms(fn, iters: int, host_ahead: bool = False) -> float:
    """Mean device time of one call of ``fn`` with the L2 flushed before
    each (L2_FLUSH_BYTES written, then CUDA events around the call alone),
    after a warm-up: the time a caller pays when the rows it reads are not
    in the L2 (host time that outlasts the flush on the card included).
    ``host_ahead`` spins the card for HOST_AHEAD_CYCLES between the flush
    and the start event, so the host has enqueued the call's launches
    before the events open and they time the card's work alone."""
    import torch

    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    fn()
    sync()
    total = 0.0
    for _ in range(iters):
        flush.zero_()
        if host_ahead:
            torch.cuda._sleep(HOST_AHEAD_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        sync()
        total += start.elapsed_time(end)
    return total / iters


def rows_bytes(layer, u, v) -> int:
    """The bytes the CSR-route intersect kernel must move for pairs (u, v)
    on an overlay-free layer without a filter: each int32 id, four indptr
    entries a pair, each entry of both rows of a pair whose rows are both
    non-empty, the int32 output."""
    from repro_torch.core.overlay import eff_row_lengths

    if layer.memb_ov is not None:
        raise ValueError("rows_bytes counts overlay-free layers")
    la = eff_row_lengths(layer.memb, None, u)
    lb = eff_row_lengths(layer.memb, None, v)
    entries = int(((la + lb) * ((la > 0) & (lb > 0))).sum())
    pairs = u.numel()
    return (12 * pairs + 4 * layer.memb.indptr.element_size() * pairs
            + layer.memb.indices.element_size() * entries)


def rows_sector_bytes(layer, u, v) -> int:
    """``rows_bytes``' reads counted as device memory serves random reads,
    in whole 32-byte sectors: each pair's indptr entries (1 or 2 sectors a
    row) and every sector a row of a pair with both rows non-empty spans;
    ids and output as they are."""
    import torch

    from repro_torch.core.csr import take_clip

    memb = layer.memb
    isz, psz = memb.indices.element_size(), memb.indptr.element_size()

    def sectors(r):
        r = r.long().clamp(0, memb.n_rows)
        r1 = (r + 1).clamp(max=memb.n_rows)
        lo = take_clip(memb.indptr, r).long() * isz
        hi = take_clip(memb.indptr, r1).long() * isz
        rows = torch.where(hi > lo, (hi - 1) // 32 - lo // 32 + 1, 0)
        return rows, 1 + (r * psz // 32 != r1 * psz // 32).long()

    ra, pa = sectors(u)
    rb, pb = sectors(v)
    both = (ra > 0) & (rb > 0)
    return 12 * u.numel() + 32 * int(((ra + rb) * both + pa + pb).sum())


def random_gather_ms(layer, count: int, device) -> float:
    """Cold time of one torch gather of ``count`` ids of ``layer``'s
    membership CSR at seeded random positions: what the card takes to
    serve that many random reads (uint16 ids read through int16)."""
    import torch

    ids = layer.memb.indices
    ids = ids.view(torch.int16) if ids.dtype == torch.uint16 else ids
    gen = torch.Generator(device=device).manual_seed(SEED)
    pos = torch.randint(0, ids.numel(), (count,), generator=gen, device=device)
    return cold_ms(lambda: ids[pos], 20)


def rows_calls(layer, u, v) -> tuple:
    """(kernel, plain): GetEdgeValue's counts for pairs (u, v) of ``layer``
    by the CSR-route intersect kernel and by its plain version."""
    from repro_torch.core.dispatch import DEFAULT_BUCKET_WIDTHS
    from repro_torch.kernels import ops, ref

    return (lambda: ops.intersect_rows(layer.memb, layer.memb_ov, u, v,
                                       widths=DEFAULT_BUCKET_WIDTHS),
            lambda: ref.intersect_rows_ref(layer.memb, layer.memb_ov, u, v, None,
                                           DEFAULT_BUCKET_WIDTHS))


def rows_timing(net, queries: dict, panel: dict, worst: dict, device) -> dict:
    """The CSR-route intersect kernel on recorded ids: the Panel's dyad
    sample (the record) and the main path's heaviest call by bytes
    (printed), each held against its plain version (the degree-bucketed
    route) bit for bit, as are the main path's other layers' ids. Kernel
    time cold (``cold_ms``); plain time by CUDA events; the bound from
    ``rows_bytes``; beside them the device busy time of the whole api call
    that the Panel phase profiled."""
    import torch

    def tensors(u, v):
        return tuple(torch.from_numpy(np.asarray(x, np.int32)).to(device)
                     for x in (u, v))

    cases = [(f"{name} x{POINT_PAIRS}", net.layer(name),
              tensors(*queries[f"getedge/{name}"])) for name, _, _ in LAYER_RECIPE]
    cases.append((f"Panel x{DYAD_PAIRS} (dyad sample)", panel["layer"],
                   tensors(*panel["dyads"])))
    err, main_case, panel_case, lines = worst["intersect_rows"], None, None, []
    tensors_of = {label: uv for label, _, uv in cases}
    for label, layer, (u, v) in cases:
        kernel, plain = rows_calls(layer, u, v)
        e = max_abs_err(kernel(), plain())
        err = max(err, e)
        case = (label, layer, kernel, plain, rows_bytes(layer, u, v))
        if layer is panel["layer"]:
            panel_case = case
        elif main_case is None or case[-1] > main_case[-1]:
            main_case = case
        lines.append(f"{label}: max_abs_err {e}")
    log("timing: intersect_rows against its plain version: " + "; ".join(lines))
    if err:
        raise AssertionError("intersect_rows disagrees with its plain version")
    rec = None
    for label, layer, kernel, plain, nbytes in (main_case, panel_case):
        ms = cold_ms(kernel, 20)
        plain_ms = cuda_ms(plain, 3)
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        rec = {
            "name": "intersect_rows", "route": "cuda",
            "source": "src/repro_torch/csrc/intersect.cu",
            "replaces": "src/repro/kernels/intersect.py:64",
            "launches": int(panel["launches"].get("intersect_rows", 0)),
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": "bytes", "library_ms": None,
            "shape": (f"{label}, {layer.memb.indices.dtype} ids over "
                      f"{layer.memb.indptr.dtype} indptr"),
            "ms_from": "cuda events, cold: L2 flushed before each launch",
        }
        sector_bytes = rows_sector_bytes(layer, *tensors_of[label])
        gather_ms = random_gather_ms(layer, sector_bytes // 32, device)
        log(f"timing: intersect_rows at {rec['shape']}: kernel {ms:.4f} ms cold, "
            f"{ms / bound:.2f}x its bound {bound:.4f} ms ({nbytes} bytes; the same "
            f"reads in whole 32-byte sectors {sector_bytes} bytes, "
            f"{sector_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms; torch's gather of as "
            f"many ids of the layer at random positions, cold: {gather_ms:.4f} ms); "
            f"plain {plain_ms:.4f} ms; no library call (no torch call counts a "
            f"per-row intersection); {device_line(CLOCK_FIELDS)}")
        check_readings(rec)
    log(f"timing: the record's whole api call (Panel phase, checkedge "
        f"x{DYAD_PAIRS}): {panel['dyad_busy']}")
    return rec  # the Panel dyads', the last


def symbol_counts(symbols) -> list:
    """``symbols`` as (name, launches a call) pairs: a bare name launches
    once a call."""
    return [(sym, 1) if isinstance(sym, str) else tuple(sym) for sym in symbols]


def call_device_ms(acts: dict, symbols, calls: int):
    """The device time of one call from a profiled window of ``calls``
    calls -> (ms or None, {symbol: events seen}). Each of ``symbols`` names
    a kernel one call launches once (matched as a substring of the device
    activity's name), or is a (name, n) pair for a kernel launched n times
    a call; ms sums, over the symbols, n times the mean duration of the
    symbol's delivered events. With every event delivered that is the
    window's summed device time of those kernels divided by the number of
    calls; where the profiler dropped some events it still counts each
    kernel n times a call. None when a symbol has no event at all. A symbol
    seen more often than n times the calls breaks the contract and raises.
    """
    seen, ms = {}, 0.0
    for sym, per_call in symbol_counts(symbols):
        own = [v for k, v in acts.items() if sym in k]
        n = sum(c for c, _ in own)
        seen[sym] = n
        if n > calls * per_call:
            times = "once" if per_call == 1 else f"{per_call} times"
            raise AssertionError(
                f"{sym}: {n} device events in a window of {calls} calls; a "
                f"listed kernel must launch {times} a call")
        if n:
            ms += per_call * sum(us for _, us in own) / n / 1e3
    return (ms if all(seen.values()) else None), seen


def kernel_record(name, symbols, source, replaces, launches, err, kernel, plain,
                  iters, nbytes, ops_count, shape, *, ops_rate=SCALAR_OPS_PER_S,
                  library=None, library_none="") -> dict:
    """``ms`` is the device time of one call of ``kernel``, summed over
    ``symbols``, the kernels one call launches, each once or (name, n) n
    times (``call_device_ms`` over the profiler's events, from the first
    of up to PROFILER_WINDOWS windows that delivered every event of the
    listed kernels: the events of a window that lost some have read under
    a kernel's bound, 40 of 50 of a draw's at half its time; where no
    window was whole, the last that saw each kernel, so it holds when the
    profiler drops events; where
    the profiler lost every event of a symbol in all windows, or every
    device event of them, the event-timed time per call, an upper bound,
    and ``ms_from`` says which);
    ``plain_ms`` the time per call of the plain version and ``library_ms``
    that of ``library``, one torch call computing the same function (None
    where there is none, for the reason ``library_none``), both from CUDA
    events over back-to-back calls. The bound counts ``ops_count`` at
    ``ops_rate``; ``check_readings`` refuses a reading under it. The
    kernel's event-timed time per call (host launch included) and the
    window's other device activity are printed beside."""
    ms, seen, acts, whole = None, {}, {}, False
    for _ in range(PROFILER_WINDOWS):
        try:
            window = device_activity(kernel, iters)
        except ProfilerLostEvents:
            window = {}  # every device event of the windows lost: as below
        window_ms, window_seen = call_device_ms(window, symbols, iters)
        if window_ms is None and ms is not None:
            continue  # keep the partial window found before
        ms, seen, acts = window_ms, window_seen, window
        whole = ms is not None and all(
            seen[sym] == iters * n for sym, n in symbol_counts(symbols))
        if whole:
            break
    names = [sym for sym, _ in symbol_counts(symbols)]
    other = {k: v for k, v in acts.items() if not any(sym in k for sym in names)}
    call_ms = cuda_ms(kernel, iters)
    ms_from = "profiler" if whole else "profiler, a window that lost events"
    if ms is None:
        # the profiler lost every window's launches of a kernel: the
        # event-timed call (host launch included) bounds its time from above
        ms, ms_from = call_ms, "cuda events, host launch included"
    plain_ms = cuda_ms(plain, max(iters // 5, 2))
    library_ms = None if library is None else cuda_ms(library, iters)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops_count / ops_rate * 1e3
    rec = {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": int(launches), "max_abs_err": err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": library_ms, "shape": shape, "ms_from": ms_from,
    }
    lib = (f"library {library_ms:.4f} ms" if library is not None
           else f"no library call ({library_none})")
    log(f"timing: {name} at {shape}: kernel {ms:.4f} ms per call over "
        f"{', '.join(names)}, from {ms_from} (events seen of {iters} calls: "
        f"{json.dumps(seen)}; {call_ms:.4f} ms per call by CUDA events, host "
        f"launch included; other device activity in the window: "
        f"{json.dumps({k: [n, round(us, 1)] for k, (n, us) in other.items()})}), "
        f"plain {plain_ms:.4f} ms, {lib}, bound {rec['bound_ms']:.4f} ms "
        f"({rec['bound_by']}: bytes {bytes_ms:.4f}, operations {ops_ms:.4f}); "
        f"{launches} launches in its phase; {device_line(CLOCK_FIELDS)}")
    return check_readings(rec)


def skewed_membership_chunks(n_nodes: int, per_node: int, n_groups: int,
                             seed: int):
    """Like ``membership_chunks``, but each draw picks a group with
    probability proportional to its target size: Pareto(HUB_TAIL) sizes,
    scaled to ``per_node * n_nodes`` memberships, with the largest groups
    held to ``HUB_MAX_SHARE`` of the nodes (clip and rescale until the
    rest carry the mass)."""
    rng = np.random.default_rng(seed)
    total = float(per_node) * n_nodes
    cap = HUB_MAX_SHARE * n_nodes
    size = rng.pareto(HUB_TAIL, n_groups) + 1.0
    for _ in range(32):
        size = np.minimum(size * (total / size.sum()), cap)
    cdf = np.cumsum(size)
    cdf /= cdf[-1]
    rows_per_chunk = max(CHUNK // per_node, 1)
    for start in range(0, n_nodes, rows_per_chunk):
        stop = min(start + rows_per_chunk, n_nodes)
        nodes = np.repeat(np.arange(start, stop, dtype=np.int64), per_node)
        groups = np.searchsorted(cdf, rng.random(nodes.size), side="right")
        yield nodes, np.minimum(groups, n_groups - 1).astype(np.int64)


def phase_hubs(net, median_income: int, device) -> None:
    """Union rows past the in-block kernel's capacity on heavy-tailed group
    sizes.

    Builds a Workplaces layer (4 memberships per node over n/20 groups)
    whose group sizes follow ``skewed_membership_chunks`` on the main
    network's nodes, drives getnodealters and filtered getdegree through
    the api with the launch counts set to 0 just before and read just
    after, fails unless the union's wide route launched and no union row
    took torch's sort, and checks a subsample bit for bit against the
    padded plain path.
    """
    import torch

    from repro_torch.core import api
    from repro_torch.core.layers import two_mode_from_membership_chunks
    from repro_torch.kernels import build

    n = net.n_nodes
    n_groups = max(int(n / 20.0), 1)
    t0 = time.perf_counter()
    layer = two_mode_from_membership_chunks(
        n, n_groups, skewed_membership_chunks(n, 4, n_groups, SEED + 200),
        device=device,
    )
    hub = api.createnetwork(net.nodeset).with_layer("Employers", layer)
    sizes = layer.hyperedge_sizes().cpu().numpy()
    log(f"hubs: Employers: {layer.n_memberships} memberships over {n_groups} "
        f"groups, max {layer.max_memberships} per node, group sizes median "
        f"{int(np.median(sizes))} / p99 {int(np.percentile(sizes, 99))} / "
        f"max {layer.max_hyperedge_size}, built in "
        f"{time.perf_counter() - t0:.3f} s")
    sel = api.selectnodes(hub, "income", ">", median_income)
    u = np.random.default_rng(SEED + 9).integers(0, n, HUB_QUERIES)
    build.launch_counts.clear()
    alters = lambda: api.getnodealters(hub, u, max_alters=MAX_ALTERS)  # noqa: E731
    degree = lambda: api.getdegree(hub, u, filter=sel)  # noqa: E731
    with wide_launches() as wide:
        alt_ms, (vals, _) = host_median_ms(alters)
        deg_ms, deg = host_median_ms(degree)
        sync()
    counts = dict(build.launch_counts)
    calls = REPEATS + 1  # warm-up + repeats, each over HUB_QUERIES rows
    log(f"hubs: launch counts {json.dumps(counts, sort_keys=True)} over "
        f"{calls} calls of each kind; wide union shapes (rows, width, "
        f"max_out): " + ", ".join(
            f"{k}x{v}" for k, v in sorted(wide.shapes.items(), key=str)))
    assert_launched("hubs", counts, WIDE_STEPS)
    assert_no_sort_rows("hubs", counts)
    log(f"hubs: getnodealters x{HUB_QUERIES}: median {alt_ms:.3f} ms, "
        + busy_share(alters, alt_ms))
    log(f"hubs: filtered getdegree x{HUB_QUERIES}: median {deg_ms:.3f} ms, "
        f"mean degree {float(deg.mean()):.2f}, " + busy_share(degree, deg_ms))

    q = HUB_ORACLE_QUERIES
    ut = torch.from_numpy(u[:q].astype(np.int32)).to(device)
    nf = sel.device_mask(device)
    want, _ = layer.node_alters_padded(ut, MAX_ALTERS)
    want_deg = layer.filtered_degree_padded(ut, nf).cpu().numpy()
    if not (torch.equal(vals[:q], want.cpu())
            and np.array_equal(deg[:q], want_deg)):
        raise AssertionError("hubs: kernel path differs from the plain path")
    log(f"hubs: {q} queries of each kind bit-identical to the padded plain path")


class Launches:
    """Within the block, wraps ``ops.<attr>``: counts the shape of every
    call (``shape(*args)``) and keeps a copy of the arguments of the
    heaviest one (by the bytes the function must move, ``nbytes(*args)``),
    so the timing phase runs the function on the data the path gave it.
    It counts nothing in ``launch_counts``."""

    def __init__(self, attr: str, nbytes, shape):
        self.attr, self._nbytes, self._shape = attr, nbytes, shape
        self.shapes = collections.Counter()
        self.heaviest = None  # (bytes, args, call)
        self.call = ""

    def __enter__(self):
        import torch

        from repro_torch.kernels import ops

        inner = self._inner = getattr(ops, self.attr)

        def record(*args, **kw):
            self.shapes[self._shape(*args)] += 1
            nbytes = self._nbytes(*args)
            if self.heaviest is None or nbytes > self.heaviest[0]:
                kept = tuple(a.clone() if isinstance(a, torch.Tensor) else a
                             for a in args)
                self.heaviest = (nbytes, kept, self.call)
            return inner(*args, **kw)

        setattr(ops, self.attr, record)
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import ops

        setattr(ops, self.attr, self._inner)


def frontier_launches() -> Launches:
    """Every frontier-kernel launch: (rows, cand, visited, max_out)."""
    return Launches(
        "frontier_compact_cuda",
        lambda cand, visited, max_out: 4 * cand.shape[0] * (
            cand.shape[1] + visited.shape[1] + max_out),
        lambda cand, visited, max_out: (*cand.shape, visited.shape[1], max_out))


def wide_launches() -> Launches:
    """Every call of the union's wide route: (rows, width, max_out), max_out
    None for a count."""
    return Launches(
        "union_wide",
        lambda flat, max_out, **kw: 4 * flat.shape[0] * (
            flat.shape[1] + (max_out or 1)),
        lambda flat, max_out, **kw: (*flat.shape, max_out))


def count_launches() -> Launches:
    """Every in-block count-only union launch: (rows, width)."""
    return Launches(
        "segmented_union_count_cuda",
        lambda flat: 4 * flat.shape[0] * (flat.shape[1] + 1),
        lambda flat: tuple(flat.shape))


WIDE_STEPS = ("segmented_union_wide", "union_merge", "union_compact")


def assert_no_sort_rows(phase: str, launches: dict) -> None:
    """No union row may leave the kernels for torch's sort on the card."""
    if launches.get("segmented_union_sort_rows", 0):
        raise AssertionError(f"union rows took the sort path in the {phase} phase")


def assert_launched(phase: str, launches: dict, keys) -> None:
    for k in keys:
        if launches.get(k, 0) == 0:
            raise AssertionError(f"kernel {k} never launched in the {phase} phase")


def phase_traversal(net, median_income: int, seed: int, device) -> dict:
    """Batched traversal through the entry points, timed per call, with the
    launch counts set to 0 just before and read just after; then the
    subsample and small-network checks. Returns the counts, the heaviest
    frontier launch and the heaviest call of the union's wide route."""
    import torch

    from repro_torch.core import api
    from repro_torch.core.traversal import ego_batch, khop_neighborhood, khop_records
    from repro_torch.kernels import build

    rng = np.random.default_rng(seed + 10)
    n = net.n_nodes
    reg_src = rng.integers(0, n, KHOP_SOURCES)
    one_src = rng.integers(0, n, ONEMODE_SOURCES)
    egos = rng.integers(0, n, EGO_NODES)
    sel = api.selectnodes(net, "income", ">", median_income)
    reg_kw = dict(max_frontier=KHOP_MAX_FRONTIER, max_alters_per_node=KHOP_NODE_CAP)
    calls = {
        # api.khop has no per-node cap (nor has the JAX package's), so the
        # capped k-hop goes through Network.khop and the same records
        f"khop all layers x{KHOP_SOURCES} k={KHOP_K} frontier "
        f"{KHOP_MAX_FRONTIER} node cap {KHOP_NODE_CAP}":
            lambda: khop_records(reg_src, *net.khop(reg_src, KHOP_K, **reg_kw)),
        f"khop Random x{ONEMODE_SOURCES} k={ONEMODE_K}":
            lambda: api.khop(net, one_src, ONEMODE_K, layernames=["Random"]),
        f"egosample x{EGO_NODES} k={EGO_K} max_alters {EGO_MAX_ALTERS}":
            lambda: api.egosample(net, egos, max_alters=EGO_MAX_ALTERS, k=EGO_K),
        "countcomponents unfiltered": lambda: api.countcomponents(net),
        f"countcomponents income > {median_income}":
            lambda: api.countcomponents(net, filter=sel),
    }
    # host_median_ms: a warm-up and the repeats; busy_share: a warm-up and
    # the profiled call
    per_call_runs = TRAVERSAL_REPEATS + 3
    outputs, latencies = {}, {}
    torch.cuda.reset_peak_memory_stats()
    build.launch_counts.clear()
    with frontier_launches() as rec, wide_launches() as wide:
        for name, call in calls.items():
            rec.call = wide.call = name
            before = collections.Counter(build.launch_counts)
            t0 = time.perf_counter()
            ms, out = host_median_ms(call, TRAVERSAL_REPEATS)
            busy = busy_share(call, ms, top=4)
            delta = collections.Counter(build.launch_counts)
            delta.subtract(before)
            per_call = {k: v / per_call_runs for k, v in delta.items() if v}
            outputs[name], latencies[name] = out, ms
            if name.startswith("countcomponents"):
                size = f"{out} components"
            elif name.startswith("egosample"):
                size = f"mean {np.mean([len(r) for r in out]):.1f} alters per ego"
            else:
                size = f"mean {np.mean([r['count'] for r in out]):.1f} nodes per source"
            log(f"traversal: {name}: median {ms:.3f} ms, {size}, {busy}; "
                f"per call {json.dumps(per_call, sort_keys=True)}; "
                f"{time.perf_counter() - t0:.3f} s in all")
    sync()
    launches = dict(build.launch_counts)
    log(f"traversal: launch counts {json.dumps(launches, sort_keys=True)}; "
        f"max_memory_allocated {torch.cuda.max_memory_allocated()}")
    log("traversal: frontier launch shapes (rows, cand, visited, max_out): "
        + ", ".join(f"{k}x{v}" for k, v in sorted(rec.shapes.items())))
    log("traversal: wide union shapes (rows, width, max_out): "
        + ", ".join(f"{k}x{v}" for k, v in sorted(wide.shapes.items(), key=str)))
    log(f"traversal: latencies ms {json.dumps(latencies, sort_keys=True)}")
    assert_launched("traversal", launches, ("frontier_compact",) + WIDE_STEPS)
    if launches.get("frontier_sort_rows", 0):
        raise AssertionError("frontier rows took the plain path on the traversal path")
    assert_no_sort_rows("traversal", launches)

    # per-source results do not depend on the batch: a subsample of each
    # call against the plain compaction and merge on the card
    q = TRAVERSAL_SUBSAMPLE
    (reg, one, ego, n_all, n_sel) = outputs.values()
    bad = []
    want = khop_records(reg_src[:q], *khop_neighborhood(
        net, reg_src[:q], KHOP_K, use_kernel=False, **reg_kw))
    if reg[:q] != want:
        bad.append("khop all layers")
    want = khop_records(one_src[:q], *khop_neighborhood(
        net, one_src[:q], ONEMODE_K, layer_names=["Random"], use_kernel=False))
    if one[:q] != want:
        bad.append("khop Random")
    vals, mask = ego_batch(net, egos[:q], EGO_MAX_ALTERS, k=EGO_K, use_kernel=False)
    vals, mask = vals.cpu().numpy(), mask.cpu().numpy()
    if ego[:q] != [vals[i][mask[i]].tolist() for i in range(q)]:
        bad.append("egosample")
    if not 1 <= n_all <= n_sel <= n:
        bad.append(f"component counts {n_all} / {n_sel}")
    small_traversal_check(device, seed, bad)
    if bad:
        raise AssertionError(f"traversal differs from its reference: {bad}")
    log(f"traversal: {q} sources of each k-hop and ego batch bit-identical to "
        f"the plain path; {SMALL_NODES}-node network: components and k-hops "
        f"equal scipy's on the materialized projection")
    return {"launches": launches, "heaviest": rec.heaviest,
            "wide": wide.heaviest}


def small_traversal_check(device, seed: int, bad: list) -> None:
    """The small network of ``small_projection_check``: components and
    k-hop groups against scipy on the materialized projection."""
    import scipy.sparse as sp
    from scipy.sparse import csgraph

    from repro_torch.core import api
    from repro_torch.core.projection import project_two_mode
    from repro_torch.core.traversal import components_batched

    net = api.createnetwork(api.createnodeset(SMALL_NODES, device=device))
    net = api.generate(net, "wk", type="2mode", h=60, a=3, seed=seed + 4)
    out = project_two_mode(net.layer("wk")).out
    adj = sp.csr_matrix(
        (np.ones(out.nnz), out.indices.cpu().numpy().astype(np.int64),
         out.indptr_host.astype(np.int64)),
        shape=(SMALL_NODES, SMALL_NODES),
    )
    n_comp, comp = csgraph.connected_components(adj, directed=False)
    min_id = np.full(n_comp, SMALL_NODES, np.int64)
    np.minimum.at(min_id, comp, np.arange(SMALL_NODES))
    labels = components_batched(net).cpu().numpy()
    if api.countcomponents(net) != n_comp or not np.array_equal(labels, min_id[comp]):
        bad.append("small/components-vs-scipy")
    src = np.random.default_rng(seed + 11).integers(0, SMALL_NODES, 32)
    dist = csgraph.shortest_path(adj, unweighted=True, indices=src)
    records = api.khop(net, src, 3, max_frontier=SMALL_NODES)
    for i, rec in enumerate(records):
        want = [v for h in (1, 2, 3) for v in np.nonzero(dist[i] == h)[0].tolist()]
        hops = [h for h in (1, 2, 3) for _ in range(int((dist[i] == h).sum()))]
        if rec["nodes"] != want or rec["hops"] != hops:
            bad.append(f"small/khop-vs-bfs source {int(src[i])}")
            break


# ---------------------------------------------------------------------------
# Sampling phase: walk fleets, neighborhood samples, estimators, analysis,
# processing, memory reports and temporal networks
# ---------------------------------------------------------------------------


def moved(obj, device):
    """A copy of a port container (frozen dataclasses of tensors, host
    arrays and metadata) with every tensor on ``device``."""
    import dataclasses

    import torch

    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if isinstance(obj, torch.device):
        return torch.device(device)
    if isinstance(obj, tuple):
        return tuple(moved(x, device) for x in obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: moved(getattr(obj, f.name), device)
            for f in dataclasses.fields(obj)})
    return obj


class DrawInputs:
    """Within the block, wraps the threefry kernels' CUDA wrappers
    (``ops.<name>_cuda``): keeps a copy of the inputs of the first launch of
    every distinct shape of each kernel and the heaviest launch by the bytes
    it must move (``draw_bytes``), so the checks and the timing phase run
    each kernel on what the sampling phase gave it. Network buffers are
    kept by reference, row ids and bounds copied. It counts nothing in
    ``launch_counts``."""

    NAMES = ("threefry_bits", "randint", "csr_row_sample")

    def __init__(self):
        self.first = {}  # (name, shape) -> (args, kwargs)
        self.heaviest = {}  # name -> (bytes, args, kwargs)
        self.shapes = collections.Counter()

    def __enter__(self):
        import torch

        from repro_torch.kernels import ops

        self._inner = {n: getattr(ops, f"{n}_cuda") for n in self.NAMES}

        def recorder(name, inner):
            def record(*args, **kwargs):
                shape = draw_shape(name, args, kwargs)
                self.shapes[(name,) + shape] += 1
                nbytes = draw_bytes(name, args, kwargs, exact=False)
                new_first = (name, shape) not in self.first
                heavier = name not in self.heaviest or nbytes > self.heaviest[name][0]
                if new_first or heavier:
                    # the rows (csr_row_sample's third argument) and bounds
                    # are copied; the CSR buffers belong to the network
                    kept = tuple(
                        a.clone() if isinstance(a, torch.Tensor)
                        and (name != "csr_row_sample" or i == 2) else a
                        for i, a in enumerate(args))
                    if new_first:
                        self.first[(name, shape)] = (kept, dict(kwargs))
                    if heavier:
                        self.heaviest[name] = (nbytes, kept, dict(kwargs))
                return inner(*args, **kwargs)
            return record

        for n, inner in self._inner.items():
            setattr(ops, f"{n}_cuda", recorder(n, inner))
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import ops

        for n, inner in self._inner.items():
            setattr(ops, f"{n}_cuda", inner)


def draw_shape(name, args, kwargs) -> tuple:
    if name == "threefry_bits":
        return (int(args[1]),)
    if name == "randint":
        return (int(args[4]),) + tuple(
            "per-element" if hasattr(b, "shape") else "scalar" for b in args[2:4])
    indptr, ids, rows = args[:3]
    return (rows.numel(), str(indptr.dtype), str(ids.dtype),
            kwargs.get("overlay") is not None)


# integer instructions of one threefry-2x32 hash in csrc/threefry.cu, the
# fewest it compiles to where the counter's high word is 0 (an element
# below 2^32): the key add to the low word (x0 starts at the key word), 20
# rounds of an add, a rotate and an xor, 5 injections of one add to x1
# each, the last injection's add to x0 (the other four fold into the next
# round's three-input add), the xor of the output words; an element at
# 2^32 or above adds the high word too (``high_word_adds``); of one int32
# randint: two hashes and at least 9 for the reduction (span, multiplier,
# remainders, a product, adds) where the multiplier (2^16 mod span)^2 mod
# span is not 0; where it is 0 (a span above 2^16, or one that divides
# 2^16) the high word's bits drop out of the offset, lb mod span, so one
# hash and at least 3 (a high product, a multiply-subtract, the add of
# lo); a span of 1 draws lo and needs no hash (the kernel draws one there
# all the same: no caller draws a scalar span of 1, and per-element
# bounds keep one plan). benchmarks/torch_draw_bwd_ab.py counts them in
# the built library's SASS. HASH_ALU_OPS: the hash's instructions that
# only the integer ALU pipe issues (the 20 rotates, the 20 round xors, the
# output xor), a diagnostic floor at ALU_LANE_OPS_PER_CLOCK, not the bound.
HASH_OPS = 1 + 20 * 3 + 5 + 1 + 1
RANDINT_OPS = 2 * HASH_OPS + 9
RANDINT_ONE_HASH_OPS = HASH_OPS + 3
HASH_ALU_OPS = 20 + 20 + 1


def draw_hash_counts(lo, hi):
    """The hashes an int32 randint draw over bounds ``lo``, ``hi`` (ints
    or int tensors of one a draw) needs, by ``_randint``'s span and
    multiplier: a 0-dim tensor for scalar bounds, else one a draw."""
    import torch

    as64 = lambda b: b.long() if isinstance(b, torch.Tensor) else torch.tensor(int(b))  # noqa: E731
    lo64, hi64 = as64(lo), as64(hi)
    span = torch.where(hi64 <= lo64, 1, (hi64 - lo64) & 0xFFFFFFFF)
    mult = ((torch.remainder(65536, span) ** 2) & 0xFFFFFFFF) % span
    return torch.where(span == 1, 0, torch.where(mult == 0, 1, 2))


def randint_hash_counts(lo, hi, n: int) -> tuple:
    """(draws that need no hash, one, two) of ``n`` int32 randint draws
    over bounds ``lo``, ``hi``."""
    hashes = draw_hash_counts(lo, hi)
    counts = [int((hashes == h).sum()) for h in range(3)]
    if hashes.dim() == 0:
        counts = [n * c for c in counts]
    return tuple(counts)


def high_word_adds(n: int, hashes=1) -> int:
    """The adds of a counter's high word to the key that ``n`` elements
    need, ``hashes`` hashes an element (an int, or a tensor of one an
    element): only elements at 2^32 and above have a high word that is not
    0."""
    tail = max(0, n - 2**32)
    if not tail:
        return 0
    if isinstance(hashes, int) or hashes.dim() == 0:
        return tail * int(hashes)
    return int(hashes[2**32:].sum())


def bits_ops(n: int) -> int:
    """The integer instructions ``n`` elements of threefry bits need."""
    return n * HASH_OPS + high_word_adds(n)


def randint_ops(args) -> int:
    """The integer instructions a randint launch (``randint_cuda``'s
    arguments) needs, counted from its bounds."""
    n = int(args[4])
    _, one, two = randint_hash_counts(args[2], args[3], n)
    return one * RANDINT_ONE_HASH_OPS + two * RANDINT_OPS \
        + high_word_adds(n, draw_hash_counts(args[2], args[3]))


def randint_hashes(args) -> int:
    """The hashes a randint launch needs."""
    _, one, two = randint_hash_counts(args[2], args[3], int(args[4]))
    return one + 2 * two


def row_sample_ops(args, kwargs) -> int:
    """The integer instructions a row sample's draws need: a randint over
    [0, max(length, 1)) a row."""
    length, _ = draw_row_lengths(args, kwargs)
    return randint_ops((None, None, 0, length.clamp(min=1), length.numel()))


def alu_floor_ms(alu_ops: int) -> float:
    """The time ``alu_ops`` integer-ALU-pipe instructions take at
    ALU_LANE_OPS_PER_CLOCK an SM, ms: a diagnostic, not a bound."""
    return alu_ops / card_int_ops_per_s() * INT_LANE_OPS_PER_CLOCK \
        / ALU_LANE_OPS_PER_CLOCK * 1e3


def draw_bytes(name, args, kwargs, exact: bool = True) -> int:
    """The bytes a draw kernel's launch must move: threefry_bits writes 4 B
    an element; randint writes 4 B and reads any per-element bound; a row
    sample reads the row id, two indptr entries (and the dirty byte of a
    delta overlay), the sampled id of each non-empty row (``exact``: counted
    from the rows; else every row), and writes 4 B and the valid byte."""
    if name == "threefry_bits":
        return 4 * int(args[1])
    if name == "randint":
        n = int(args[4])
        return 4 * n + sum(4 * n for b in args[2:4] if hasattr(b, "shape"))
    indptr, ids, rows = args[:3]
    n = rows.numel()
    per_row = 4 + 2 * indptr.element_size() + 4 + 1
    if kwargs.get("overlay") is not None:
        per_row += 1
    filled = n if not exact else int(draw_row_lengths(args, kwargs)[0].gt(0).sum())
    return n * per_row + filled * ids.element_size()


def draw_csrs(args, kwargs):
    """A row-sample launch's arguments as (base CSR, overlay or None) for
    the plain version."""
    from repro_torch.core.csr import CSR
    from repro_torch.core.overlay import DeltaOverlay

    def csr(indptr, ids):
        return CSR(indptr=indptr, indices=ids, values=None,
                   n_rows=indptr.numel() - 1, n_cols=0, indptr_host=None)

    base = csr(*args[:2])
    ov = kwargs.get("overlay")
    if ov is not None:
        ov = DeltaOverlay(delta=csr(ov[1], ov[2]), dirty=ov[0], base_shadowed=0,
                          dirty_host=None)
    return base, ov


def draw_row_lengths(args, kwargs):
    """(length, indptr position) of each sampled row, with the kernel's
    clip rules; the position is that of the base or the delta CSR."""
    import torch

    from repro_torch.core.csr import take_clip

    base, ov = draw_csrs(args, kwargs)
    r = args[2].long()
    length = take_clip(base.indptr, r + 1).long() - take_clip(base.indptr, r).long()
    pos = r.clamp(0, base.n_rows)
    if ov is not None:
        d = take_clip(ov.dirty, r)
        dl = (take_clip(ov.delta.indptr, r + 1).long()
              - take_clip(ov.delta.indptr, r).long())
        length = torch.where(d, dl, length)
        pos = torch.where(d, r.clamp(0, ov.delta.n_rows), pos)
    return length, pos


def draw_sector_bytes(args, kwargs) -> int:
    """A row sample's random reads counted as device memory serves them,
    in whole 32-byte sectors: each row's indptr pair (1 or 2 sectors) and
    the sampled id of each non-empty row (1 sector); row ids and outputs
    as they are."""
    indptr, ids, rows = args[:3]
    length, pos = draw_row_lengths(args, kwargs)
    psz = indptr.element_size()
    pairs = 1 + (pos * psz // 32 != (pos + 1) * psz // 32).long()
    return 9 * rows.numel() + 32 * int(pairs.sum() + length.gt(0).sum())


def draw_plain(name, args, kwargs):
    """The plain torch version of a threefry kernel's CUDA wrapper on the
    same arguments -> a tuple of output tensors."""
    from repro_torch.kernels import ref

    if name == "threefry_bits":
        return (ref.threefry_bits_ref(*args),)
    if name == "randint":
        return (ref.randint_ref(*args),)
    base, ov = draw_csrs(args, kwargs)
    return ref.csr_row_sample_ref(base, ov, args[2], *args[3:5])


def draw_kernel(name, args, kwargs):
    from repro_torch.kernels import ops

    out = getattr(ops, f"{name}_cuda")(*args, **kwargs)
    return out if isinstance(out, tuple) else (out,)


def exact_check(label: str, got, want) -> None:
    """Fails unless every output tensor of a kernel equals its plain
    version's element for element (dtype and shape included)."""
    for g, w in zip(got, want):
        g, w = g.cpu(), w.cpu()
        if g.dtype != w.dtype or g.shape != w.shape:
            raise AssertionError(
                f"{label}: {g.dtype}{tuple(g.shape)} vs {w.dtype}{tuple(w.shape)}")
        bad = int((g != w).sum())
        if bad:
            raise AssertionError(f"{label}: {bad} of {w.numel()} elements differ "
                                 "from the plain version")


def draw_err(got, want) -> int:
    """The largest absolute difference over a draw kernel's outputs (bool
    outputs as 0/1)."""
    return max(max_abs_err(g, w) for g, w in zip(got, want))


def fleet_choices(keys, logits, n: int, device):
    """Each step's layer choice of n walkers -> int32[steps, n] on the host,
    from the (layer-choice, step) keys of ``walk_keys``."""
    import torch

    from repro_torch.core import prng

    lg = logits.to(device)
    return torch.stack([prng.categorical(k_layer, lg, (n,)).cpu()
                        for k_layer, _ in keys]).numpy()


def prefix_check(label: str, got, want, excused, checked: int) -> str:
    """The rows of ``got`` (the card's) against ``want`` (the CPU path's):
    every row must be equal, except the rows ``excused`` (bool[rows]: a
    layer choice on the card differed from the CPU's there), and at most
    CHOICE_TOL of the ``checked`` walkers whose choices were compared may
    have such a difference."""
    got, want = np.asarray(got), np.asarray(want)
    if got.shape != want.shape:
        raise AssertionError(f"{label}: shape {got.shape} vs {want.shape}")
    differ = (got != want).reshape(got.shape[0], -1).any(axis=1)
    excused = np.asarray(excused, bool)[: got.shape[0]]
    wrong = np.flatnonzero(differ & ~excused)
    if wrong.size:
        raise AssertionError(
            f"{label}: {wrong.size} rows differ from the CPU path with the same "
            f"layer choices (first: row {int(wrong[0])})")
    n_excused = int(np.asarray(excused).sum())
    if n_excused > CHOICE_TOL * checked:
        raise AssertionError(
            f"{label}: {n_excused} of {checked} walkers chose another layer on "
            f"the card than on the CPU (limit {CHOICE_TOL:g} of them)")
    return (f"{label}: {got.shape[0]} rows equal the CPU path "
            f"({int(differ.sum())} differ, each after a layer choice that "
            f"differed)")


def profiled(fn) -> tuple:
    """One call of ``fn`` under the profiler -> (wall ms, device busy ms,
    busiest activities, output). For calls too heavy to repeat."""
    from torch.profiler import ProfilerActivity, profile

    sync()
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=".*Profiler clears events")
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            out = fn()
            sync()
            wall = (time.perf_counter() - t0) * 1e3
    return wall, device_events(prof), out


def busy_line(acts: dict, wall_ms: float, top: int = 4) -> str:
    busy = sum(us for _, us in acts.values()) / 1e3
    ranked = sorted(acts.items(), key=lambda kv: -kv[1][1])[:top]
    return (f"device busy {busy:.3f} ms, idle "
            f"{max(0.0, 1.0 - busy / wall_ms) * 100:.1f}%; most busy: " + ", ".join(
                f"{name[:60]} x{n} {us / 1e3:.3f} ms" for name, (n, us) in ranked))


def processing_layer(n_nodes: int, seed: int, device):
    """A directed, valued Erdős–Rényi layer (mean out-degree
    PROCESSING_DEGREE, values 1-5) for the processing calls."""
    from repro_torch.core.layers import one_mode_from_edges

    rng = np.random.default_rng(seed)
    m = int(n_nodes * PROCESSING_DEGREE)
    src = rng.integers(0, n_nodes, m)
    dst = rng.integers(0, n_nodes, m)
    vals = rng.integers(1, 6, m).astype(np.float32)
    return one_mode_from_edges(n_nodes, src, dst, values=vals, directed=True,
                               device=device)


def temporal_network(seed: int, device):
    """TEMPORAL_YEARS snapshots of a TEMPORAL_NODES-node register network
    (the Households and Workplaces recipe, redrawn each year)."""
    from repro_torch.core import api
    from repro_torch.core.layers import two_mode_from_membership_chunks
    from repro_torch.core.temporal import TemporalNetwork

    n = TEMPORAL_NODES
    ns = api.createnodeset(n, device=device)
    snaps = []
    for i, year in enumerate(TEMPORAL_YEARS):
        net = api.createnetwork(ns)
        for j, (name, per_node, npg) in enumerate(LAYER_RECIPE[:2]):
            groups = max(int(n / npg), 1)
            net = net.with_layer(name, two_mode_from_membership_chunks(
                n, groups, membership_chunks(n, per_node, groups, seed + 10 * i + j),
                device=device))
        snaps.append((year, net))
    return TemporalNetwork.from_snapshots(snaps)


def sampling_calls(net, layers, sel, median_income: int, seed: int, device) -> dict:
    """The sampling phase's calls: name -> (call, timed repeats or None for
    one profiled call only), and the inputs the checks need."""
    from repro_torch.core import analysis, api, estimators, prng, processing, walks
    from repro_torch.core.nodeset import NodeSelection

    rng = np.random.default_rng(seed + 20)
    n = net.n_nodes
    ins = {
        "fleet": rng.integers(0, n, FLEET_STARTS),
        "one": rng.integers(0, n, ONE_LAYER_WALKERS),
        "ns_walk": rng.integers(0, n, NS_WALK_SEEDS),
        "ns_alters": rng.integers(0, n, NS_ALTERS_SEEDS),
        "proj": rng.integers(0, n, PROJ_DEGREE_NODES),
        "bfs": int(rng.integers(0, n)),
        "target": int(rng.integers(0, n)),
        "subnet": NodeSelection(rng.random(n) < SUBNET_SHARE),
        "seeds": {k: seed + 21 + i for i, k in enumerate(
            ("fleet", "one", "ns_walk", "ns_alters", "est"))},
    }
    t0 = time.perf_counter()
    proc = processing_layer(PROCESSING_NODES, seed + 30, device)
    temporal = temporal_network(seed + 40, device)
    tpairs = rng.integers(0, TEMPORAL_NODES, (TEMPORAL_PAIRS, 2))
    log(f"sampling: processing layer ({PROCESSING_NODES} nodes, {proc.n_edges} "
        f"directed valued edges) and {len(TEMPORAL_YEARS)} temporal snapshots of "
        f"{TEMPORAL_NODES} nodes built in {time.perf_counter() - t0:.3f} s")
    ins.update(proc=proc, temporal=temporal)
    s = ins["seeds"]
    est_key = prng.key(s["est"])
    win = temporal.window(TEMPORAL_YEARS[0], TEMPORAL_YEARS[-1])
    calls = {
        f"walkbatch x{FLEET_STARTS} starts x{FLEET_WALKERS} walkers x{FLEET_STEPS} "
        f"steps, 4 layers weighted {list(FLEET_WEIGHTS)}, income > {median_income}":
            (lambda: api.walkbatch(net, ins["fleet"], FLEET_STEPS, walkers=FLEET_WALKERS,
                                   seed=s["fleet"], layernames=layers,
                                   layer_weights=FLEET_WEIGHTS, filter=sel), 1),
        f"walkbatch Households x{ONE_LAYER_WALKERS} x{FLEET_STEPS} steps":
            (lambda: api.walkbatch(net, ins["one"], FLEET_STEPS, seed=s["one"],
                                   layernames=["Households"]), 1),
        f"neighborhood_sample walk x{NS_WALK_SEEDS} fanout {list(NS_FANOUT)}":
            (lambda: walks.neighborhood_sample(net, ins["ns_walk"], NS_FANOUT,
                                               prng.key(s["ns_walk"]), layers), 1),
        f"neighborhood_sample alters x{NS_ALTERS_SEEDS} fanout {list(NS_FANOUT)}":
            (lambda: walks.neighborhood_sample(net, ins["ns_alters"], NS_FANOUT,
                                               prng.key(s["ns_alters"]), layers,
                                               method="alters"), 1),
        f"estimate_mean_degree x{EST_NODES}":
            (lambda: estimators.estimate_mean_degree(net, EST_NODES, est_key, layers), 1),
        f"estimate_degree_distribution {EST_WALKERS} walkers x{EST_STEPS}":
            (lambda: estimators.estimate_degree_distribution(
                net, EST_WALKERS, EST_STEPS, est_key, layers), 1),
        f"estimate_assortativity income {EST_WALKERS} walkers x{EST_STEPS}":
            (lambda: estimators.estimate_assortativity(
                net, "income", EST_WALKERS, EST_STEPS, est_key, layers), 1),
        f"estimate_component_mass {EST_WALKERS} walkers x{EST_STEPS}":
            (lambda: estimators.estimate_component_mass(
                net, EST_WALKERS, EST_STEPS, est_key, layers), 1),
        "degreedist unfiltered": (lambda: api.degreedist(net, layers), 1),
        f"degreedist income > {median_income}":
            (lambda: api.degreedist(net, layers, filter=sel), 1),
        "getdensity per layer": (lambda: [api.getdensity(net, nm) for nm in layers], 1),
        f"projected_degree x{PROJ_DEGREE_NODES}":
            (lambda: analysis.projected_degree(net, ins["proj"], layers), 1),
        f"bfs_distances from {ins['bfs']}, all layers":
            (lambda: analysis.bfs_distances(net, ins["bfs"], layers), 1),
        f"shortestpath {ins['bfs']} -> {ins['target']}":
            (lambda: api.shortestpath(net, ins["bfs"], ins["target"], layers), 1),
        "countcomponents (analysis.connected_components)":
            (lambda: api.countcomponents(net, layers), 1),
        "memoryreport": (lambda: api.memoryreport(net), None),
        "describenet": (lambda: api.describenet(net), None),
        f"subnetwork on {ins['subnet'].count} seeded nodes":
            (lambda: api.subnetwork(net, ins["subnet"]), None),
        f"symmetrize max ({PROCESSING_NODES}-node directed valued layer)":
            (lambda: processing.symmetrize(proc, "max"), None),
        "dichotomize > 2": (lambda: processing.dichotomize(proc, 2.0, "gt"), None),
        "filter_edges >= 3": (lambda: processing.filter_edges(proc, 3.0), None),
        f"temporal edge_years + first_contact x{TEMPORAL_PAIRS}, memory_by_year":
            (lambda: ([temporal.edge_years("Workplaces", int(u), int(v))
                       for u, v in tpairs],
                      [temporal.first_contact(int(u), int(v)) for u, v in tpairs],
                      temporal.memory_by_year()), None),
        f"temporal window walk x{TEMPORAL_WALKERS} x{FLEET_STEPS} steps":
            (lambda: walks.random_walk(win, np.arange(TEMPORAL_WALKERS), FLEET_STEPS,
                                       prng.key(seed + 45)), 1),
    }
    return calls, ins


def phase_sampling(net, median_income: int, seed: int, device) -> dict:
    """The sampling and analysis calls through the entry points, timed per
    call, with the launch counts set to 0 just before and read just after;
    then the checks: the threefry kernels and the segmented union launched,
    each threefry kernel equal to its plain version at every shape the
    phase gave it, the first PREFIX_STARTS starts' rows of each fleet and
    sample equal to the port's CPU path (a walker whose layer choice on the
    card differed from the CPU's excused, at most CHOICE_TOL of them),
    BFS against a k-hop, a small network against scipy. Returns the counts
    and the recorded launches."""
    import torch

    from repro_torch.core import api
    from repro_torch.kernels import build

    layers = [nm for nm, _, _ in LAYER_RECIPE] + ["Random"]
    sel = api.selectnodes(net, "income", ">", median_income)
    calls, ins = sampling_calls(net, layers, sel, median_income, seed, device)
    outputs, latencies = {}, {}
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    build.launch_counts.clear()
    with DrawInputs() as rec:
        for name, (call, repeats) in calls.items():
            before = collections.Counter(build.launch_counts)
            t0 = time.perf_counter()
            if repeats is None:
                ms, acts, out = profiled(call)
                runs = 1
            else:
                ms, out = host_median_ms(call, repeats)
                _, acts, _ = profiled(call)
                runs = repeats + 2
            delta = collections.Counter(build.launch_counts)
            delta.subtract(before)
            per_call = {k: v / runs for k, v in delta.items() if v}
            outputs[name], latencies[name] = out, ms
            log(f"sampling: {name}: {'one profiled call' if repeats is None else 'median'}"
                f" {ms:.3f} ms, {busy_line(acts, ms)}; per call "
                f"{json.dumps(per_call, sort_keys=True)}; {time.perf_counter() - t0:.3f} s"
                " in all")
    sync()
    launches = dict(build.launch_counts)
    log(f"sampling: launch counts {json.dumps(launches, sort_keys=True)}; "
        f"max_memory_allocated {torch.cuda.max_memory_allocated()}; "
        f"{time.perf_counter() - t_phase:.3f} s for the calls")
    log("sampling: threefry launch shapes: " + ", ".join(
        f"{k}x{v}" for k, v in sorted(rec.shapes.items(), key=str)))
    log(f"sampling: latencies ms {json.dumps(latencies, sort_keys=True)}")
    assert_launched("sampling", launches, DrawInputs.NAMES + ("segmented_union",))
    worst = {}
    for (kname, shape), (args, kwargs) in rec.first.items():
        exact_check(f"{kname} at {shape}", draw_kernel(kname, args, kwargs),
                    draw_plain(kname, args, kwargs))
        worst[kname] = 0
    log(f"sampling: each threefry kernel equals its plain version at all "
        f"{len(rec.first)} launch shapes of the phase")
    sampling_checks(net, layers, sel, ins, list(outputs.values()), seed, device)
    return {"launches": launches, "heaviest": rec.heaviest, "worst": worst,
            "shapes": rec.shapes, "first": rec.first}


def sampling_checks(net, layers, sel, ins, outs, seed: int, device) -> None:
    """The prefix checks against the port's CPU path on a host copy of the
    network, BFS against a k-hop, sanity of the other outputs, and a small
    network's BFS and shortest paths against scipy."""
    from repro_torch.core import analysis, prng, walks
    from repro_torch.core.traversal import (
        khop_neighborhood, khop_records, random_walk_batch, walk_keys,
    )

    import torch

    t0 = time.perf_counter()
    cpu = torch.device("cpu")
    host = moved(net, cpu)
    log(f"sampling: host copy of the network in {time.perf_counter() - t0:.3f} s")
    s = ins["seeds"]
    n = net.n_nodes
    (fleet, one, ns_walk, ns_alters, mean_deg, _, _, mass, dd, dd_sel, dens, proj,
     dist, hops, n_comp, mem, desc, sub, sym, dich, filt, temporal, twalk) = outs
    q = PREFIX_STARTS
    lines = []

    # the 4-layer fleet: layer choices of the first CHOICE_WALKERS walkers on
    # the card and on the CPU, then the first q starts' rows
    from repro_torch.core.walks import _layer_logits

    logits = _layer_logits(len(layers), FLEET_WEIGHTS)
    keys = walk_keys(prng.key(s["fleet"]), FLEET_STEPS)
    n_walkers = FLEET_STARTS * FLEET_WALKERS
    card = fleet_choices(keys, logits, n_walkers, device)[:, :CHOICE_WALKERS]
    host_choice = fleet_choices(keys, logits, CHOICE_WALKERS, cpu)
    excused = (card != host_choice).any(axis=0)
    log(f"sampling: layer choices of {CHOICE_WALKERS} fleet walkers x "
        f"{FLEET_STEPS} steps: {int(excused.sum())} walkers chose otherwise on "
        f"the card than on the CPU ({int((card != host_choice).sum())} choices)")
    want = random_walk_batch(host, ins["fleet"][:q], FLEET_STEPS, prng.key(s["fleet"]),
                             walkers_per_start=FLEET_WALKERS, layer_names=layers,
                             layer_weights=FLEET_WEIGHTS, node_filter=sel)
    lines.append(prefix_check("walkbatch 4 layers", fleet[: q * FLEET_WALKERS],
                              want.numpy(), excused, CHOICE_WALKERS))
    fl = np.asarray(fleet)
    if fl.shape != (n_walkers, FLEET_STEPS + 1) or fl.min() < 0 or fl.max() >= n:
        raise AssertionError(f"walkbatch fleet of shape {fl.shape} out of range")
    want = random_walk_batch(host, ins["one"][:q], FLEET_STEPS, prng.key(s["one"]),
                             layer_names=["Households"])
    lines.append(prefix_check("walkbatch Households", one[:q], want.numpy(),
                              np.zeros(q, bool), q))

    # neighborhood samples: per seed, its hop-1 and hop-2 samples as one row
    def seed_rows(hops_, b):
        return np.concatenate([np.asarray(h.cpu()).reshape(b, -1) for h in hops_], 1)

    # a seed is excused where any of its draws chose another layer on the
    # card: hop h's draw j belongs to seed j // (fanout[0] * ... * fanout[h])
    key = prng.key(s["ns_walk"])
    uniform = _layer_logits(len(layers), None)
    excused = np.zeros(NS_WALK_SEEDS, bool)
    width = 1
    for f in NS_FANOUT:
        key, k_layer, _ = prng.split(key, 3)
        width *= f
        m = NS_WALK_SEEDS * width
        diff = (fleet_choices([(k_layer, None)], uniform, m, device)[0]
                != fleet_choices([(k_layer, None)], uniform, m, cpu)[0])
        excused |= diff.reshape(NS_WALK_SEEDS, width).any(axis=1)
    want = walks.neighborhood_sample(host, ins["ns_walk"][:q], NS_FANOUT,
                                     prng.key(s["ns_walk"]), layers)
    lines.append(prefix_check(
        "neighborhood_sample walk", seed_rows(ns_walk, NS_WALK_SEEDS)[:q],
        seed_rows(want, q), excused, NS_WALK_SEEDS))
    qa = NS_ALTERS_PREFIX
    want = walks.neighborhood_sample(host, ins["ns_alters"][:qa], NS_FANOUT,
                                     prng.key(s["ns_alters"]), layers, method="alters")
    lines.append(prefix_check(
        "neighborhood_sample alters", seed_rows(ns_alters, NS_ALTERS_SEEDS)[:qa],
        seed_rows(want, qa), np.zeros(qa, bool), qa))

    # the rest: in range, and against exact host counts
    bad = []
    sample = prng.randint(prng.key(s["est"]), (EST_NODES,), 0, n, cpu).numpy()
    exact = float(host_degrees(host, layers)[sample].mean())
    if not abs(mean_deg - exact) <= 1e-5 * exact:
        bad.append(f"estimate_mean_degree {mean_deg} vs {exact}")
    if not 0.0 <= mass <= 1.0:
        bad.append(f"estimate_component_mass {mass}")
    if sum(c for _, c in dd) != n or sum(c for _, c in dd_sel) != sel.count:
        bad.append("degreedist counts")
    if not all(0.0 <= d <= 1.0 for d in dens):
        bad.append(f"getdensity {dens}")
    if proj.shape != (PROJ_DEGREE_NODES,) or int(proj.min()) < 0:
        bad.append("projected_degree")
    if not 1 <= n_comp <= n or mem.total_nbytes != net.nbytes:
        bad.append(f"countcomponents {n_comp} / memoryreport {mem.total_nbytes}")
    if desc["n_nodes"] != n or sub.n_nodes != ins["subnet"].count:
        bad.append("describenet / subnetwork")
    if sym.directed or dich.n_edges > ins["proc"].n_edges or filt.n_edges > ins["proc"].n_edges:
        bad.append("processing")
    if twalk.shape != (TEMPORAL_WALKERS, FLEET_STEPS + 1):
        bad.append("temporal window walk")
    # BFS levels against k-hop groups from the same source: all layers at
    # k=1 (~14,700 nodes: 6 schools of ~2,400), and Households + Random at
    # k=2 (Workplaces' ~316 alters a node make a 2-hop set of ~10^5, past
    # any frontier cap); a group as large as the cap would be cut
    d = dist.cpu().numpy()
    src = ins["bfs"]
    for sub_layers, k in ((layers, 1), (["Households", "Random"], 2)):
        dk = d if k == 1 else analysis.bfs_distances(net, src, sub_layers).cpu().numpy()
        rec = khop_records([src], *khop_neighborhood(
            net, [src], k, max_frontier=BFS_CHECK_FRONTIER, layer_names=sub_layers))[0]
        for h in range(1, k + 1):
            got = sorted(np.flatnonzero(dk == h).tolist())
            want_h = [v for v, hh in zip(rec["nodes"], rec["hops"]) if hh == h]
            if got != want_h or len(want_h) >= BFS_CHECK_FRONTIER:
                bad.append(f"bfs level {h} ({len(got)} nodes) vs khop over "
                           f"{sub_layers} ({len(want_h)})")
            lines.append(f"BFS level {h} over {sub_layers}: {len(got)} nodes, equal "
                         "to the k-hop group")
    if hops != (int(d[ins["target"]]) if d[ins["target"]] < 2**31 - 1 else -1):
        bad.append(f"shortestpath {hops} vs bfs {int(d[ins['target']])}")
    small_sampling_check(device, seed, bad)
    if bad:
        raise AssertionError(f"sampling outputs differ from their references: {bad}")
    for line in lines:
        log(f"sampling: {line}")
    log(f"sampling: BFS levels equal k-hop groups; shortestpath equals the BFS "
        f"distance; {SMALL_NODES}-node network: BFS distances and shortest paths "
        f"equal scipy's on the materialized projection; checks "
        f"{time.perf_counter() - t0:.3f} s")


def host_degrees(net, layers) -> np.ndarray:
    from repro_torch.core.analysis import degree_centrality

    return degree_centrality(net, layers).cpu().numpy().astype(np.float64)


def small_sampling_check(device, seed: int, bad: list) -> None:
    """The small network of ``small_projection_check``: BFS distances from
    32 sources and 16 shortest paths against scipy on the materialized
    projection."""
    import scipy.sparse as sp
    from scipy.sparse import csgraph

    from repro_torch.core import analysis, api
    from repro_torch.core.projection import project_two_mode

    net = api.createnetwork(api.createnodeset(SMALL_NODES, device=device))
    net = api.generate(net, "wk", type="2mode", h=60, a=3, seed=seed + 4)
    out = project_two_mode(net.layer("wk")).out
    adj = sp.csr_matrix(
        (np.ones(out.nnz), out.indices.cpu().numpy().astype(np.int64),
         out.indptr_host.astype(np.int64)), shape=(SMALL_NODES, SMALL_NODES))
    rng = np.random.default_rng(seed + 12)
    src = rng.integers(0, SMALL_NODES, 32)
    dist = csgraph.shortest_path(adj, unweighted=True, indices=src)
    for i, s in enumerate(src):
        got = analysis.bfs_distances(net, int(s)).cpu().numpy()
        want = np.where(np.isinf(dist[i]), 2**31 - 1, dist[i]).astype(np.int32)
        if not np.array_equal(got, want):
            bad.append(f"small/bfs-vs-scipy source {int(s)}")
            break
    targets = rng.integers(0, SMALL_NODES, 16)
    for i, t in enumerate(targets):
        want = -1 if np.isinf(dist[i][t]) else int(dist[i][t])
        if api.shortestpath(net, int(src[i]), int(t)) != want:
            bad.append(f"small/shortestpath-vs-scipy {int(src[i])} -> {int(t)}")
            break


def draw_timing(sampling: dict) -> list:
    """The threefry kernels at the sampling phase's heaviest launch of each:
    ``threefry_bits`` and ``randint`` by ``kernel_record`` (bound: the
    output bytes or the hashes' integer instructions at
    ``card_int_ops_per_s``, the larger);
    ``csr_row_sample`` cold (the rows lie at random in a layer larger than
    the L2), CUDA events with the L2 flushed before each launch, its bytes
    bound with the same reads in 32-byte sectors beside it; printed beside
    it, the same launch on the card alone (``cold_ms(host_ahead=True)``)
    and both readings at the phase's three most frequent launch shapes,
    each with its launch count and launches x (device time - bound)."""
    import torch

    records = []
    launches, worst = sampling["launches"], sampling["worst"]
    int_rate = card_int_ops_per_s()
    log(f"timing: integer instructions at {int_rate:.4g} a second ("
        f"{INT_LANE_OPS_PER_CLOCK} lane instructions a clock an SM at the maximum SM "
        f"clock); a hash counted {HASH_OPS} below 2^32 elements, a randint {RANDINT_OPS} "
        f"({RANDINT_ONE_HASH_OPS} where the high word drops out, none at span 1)")
    for name, replaces in (
        ("threefry_bits",
         "none: XLA fuses jax.random's threefry2x32 on the TPU (the layer "
         "choice, src/repro/core/traversal.py:369)"),
        ("randint",
         "none: XLA fuses jax.random.randint on the TPU "
         "(src/repro/core/estimators.py:48)"),
    ):
        _, args, kwargs = sampling["heaviest"][name]
        if name == "threefry_bits":
            n, ops, hashes = int(args[1]), bits_ops(int(args[1])), int(args[1])
        else:
            n, ops, hashes = int(args[4]), randint_ops(args), randint_hashes(args)
        kernel = lambda a=args, k=kwargs, nm=name: draw_kernel(nm, a, k)  # noqa: E731
        plain = lambda a=args, k=kwargs, nm=name: draw_plain(nm, a, k)  # noqa: E731
        err = draw_err(kernel(), plain())
        rec = kernel_record(
            name, (f"{name}_kernel",), "src/repro_torch/csrc/threefry.cu", replaces,
            launches.get(name, 0), max(err, worst.get(name, 0)), kernel, plain, 50,
            draw_bytes(name, args, kwargs), ops,
            f"{draw_shape(name, args, kwargs)} (the sampling phase's heaviest)",
            ops_rate=int_rate,
            library_none="no torch call draws threefry bits (torch's generators "
                         "are Philox)",
        )
        records.append(rec)
        device = args[-1]
        buf = torch.empty(n, dtype=torch.int32, device=device)
        alone = [cold_ms(fn, 20, host_ahead=True) for fn in (
            kernel, lambda: buf.fill_(0),
            lambda: torch.randint(0, 2**31 - 1, (n,), dtype=torch.int32, device=device))]
        log(f"timing: {name} at {rec['shape']}: on the card alone the kernel "
            f"{alone[0]:.4f} ms beside yardsticks on the card: fill_(0) of {n} int32 "
            f"{alone[1]:.4f} ms, torch.randint of {n} int32 (Philox) {alone[2]:.4f} ms; "
            f"ALU-pipe floor ({hashes} hashes x {HASH_ALU_OPS} rotates and xors at "
            f"{ALU_LANE_OPS_PER_CLOCK} lanes a clock an SM, a diagnostic) "
            f"{alu_floor_ms(hashes * HASH_ALU_OPS):.4f} ms; bound {rec['bound_ms']:.4f} ms")
    _, args, kwargs = sampling["heaviest"]["csr_row_sample"]
    kernel = lambda: draw_kernel("csr_row_sample", args, kwargs)  # noqa: E731
    plain = lambda: draw_plain("csr_row_sample", args, kwargs)  # noqa: E731
    err = max(draw_err(kernel(), plain()), worst.get("csr_row_sample", 0))
    ms = cold_ms(kernel, 20)
    plain_ms = cuda_ms(plain, 5)
    nbytes = draw_bytes("csr_row_sample", args, kwargs)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = row_sample_ops(args, kwargs) / int_rate * 1e3
    sectors = draw_sector_bytes(args, kwargs)
    rec = {
        "name": "csr_row_sample", "route": "cuda",
        "source": "src/repro_torch/csrc/threefry.cu",
        "replaces": "none: XLA fuses csr_row_sample's gathers and draw on the TPU "
                    "(src/repro/core/csr.py:538)",
        "launches": int(launches.get("csr_row_sample", 0)),
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None,
        "shape": f"{draw_shape('csr_row_sample', args, kwargs)} (the sampling "
                 "phase's heaviest)",
        "ms_from": "cuda events, cold: L2 flushed before each launch",
    }
    device_ms = cold_ms(kernel, 20, host_ahead=True)
    log(f"timing: csr_row_sample at {rec['shape']}: kernel {ms:.4f} ms cold, "
        f"{device_ms:.4f} ms on the card alone, "
        f"{ms / rec['bound_ms']:.2f}x its bound {rec['bound_ms']:.4f} ms ({nbytes} "
        f"bytes, operations {ops_ms:.4f} ms; the same reads in whole 32-byte sectors "
        f"{sectors} bytes, {sectors / HBM_BYTES_PER_S * 1e3:.4f} ms); plain "
        f"{plain_ms:.4f} ms; no library call (no torch call draws a threefry row "
        f"sample); {rec['launches']} launches in its phase; {device_line(CLOCK_FIELDS)}")
    records.append(check_readings(rec))
    row_sample_shapes(sampling, int_rate)
    return records


ROW_SAMPLE_SHAPES = 3  # the most frequent launch shapes row_sample_shapes times


def row_sample_shapes(sampling: dict, int_rate: float) -> float:
    """``csr_row_sample`` cold and on the card alone at the sampling
    phase's ``ROW_SAMPLE_SHAPES`` most frequent launch shapes (the inputs
    of the first launch of each), each with its launch count, bound and
    launches x (device time - bound) -> that sum over the shapes, ms. A
    reading under its bound fails, as ``check_readings`` fails one."""
    counts = [(count, shape[1:]) for shape, count in sampling["shapes"].items()
              if shape[0] == "csr_row_sample"]
    loss = 0.0
    for count, shape in sorted(counts, key=lambda c: -c[0])[:ROW_SAMPLE_SHAPES]:
        args, kwargs = sampling["first"][("csr_row_sample", shape)]
        kernel = lambda a=args, k=kwargs: draw_kernel("csr_row_sample", a, k)  # noqa: E731
        ms = cold_ms(kernel, 20)
        device_ms = cold_ms(kernel, 20, host_ahead=True)
        bound = max(draw_bytes("csr_row_sample", args, kwargs) / HBM_BYTES_PER_S,
                    row_sample_ops(args, kwargs) / int_rate) * 1e3
        sectors_ms = draw_sector_bytes(args, kwargs) / HBM_BYTES_PER_S * 1e3
        check_readings({"name": f"csr_row_sample at {shape}", "ms": device_ms,
                        "library_ms": None, "bound_ms": bound})
        loss += count * (device_ms - bound)
        log(f"timing: csr_row_sample at {shape}: {count} launches in the sampling "
            f"phase; kernel {ms:.4f} ms cold, {device_ms:.4f} ms on the card alone; "
            f"bound {bound:.4f} ms, 32-byte sectors {sectors_ms:.4f} ms; launches x "
            f"(time on the card - bound) {count * (device_ms - bound):.4f} ms")
    log(f"timing: csr_row_sample at the {ROW_SAMPLE_SHAPES} most frequent shapes: "
        f"launches x (time on the card - bound) {loss:.4f} ms in all")
    return loss


# ---------------------------------------------------------------------------
# Storage phase: files, mutation, durability and the CLI
# ---------------------------------------------------------------------------


def tensor_bits(t):
    """``t`` as a tensor torch compares on every device (uint16 as int16)."""
    import torch

    return t.view(torch.int16) if t.dtype == torch.uint16 else t


def net_buffers(net) -> list:
    """(name, tensor or host array) of every buffer of a network: the
    attributes, each layer's CSRs with their indptr host mirrors, and each
    overlay's delta CSR, dirty mask and its host mirror; with the scalars
    beside them."""
    out = [("n_nodes", net.n_nodes), ("layer_names", net.layer_names)]
    for an, col in zip(net.nodeset.attrs.names, net.nodeset.attrs.columns):
        out += [(f"attr.{an}.kind", col.kind), (f"attr.{an}.ids", col.node_ids),
                (f"attr.{an}.values", col.values)]

    def csr(key, c):
        if c is None:
            return [(key, None)]
        return [(f"{key}.shape", (c.n_rows, c.n_cols)), (f"{key}.indptr", c.indptr),
                (f"{key}.indptr_host", c.indptr_host), (f"{key}.indices", c.indices),
                (f"{key}.values", c.values)]

    for name, layer in zip(net.layer_names, net.layers):
        if layer.mode == 2:
            parts = (("memb", layer.memb, layer.memb_ov),
                     ("members", layer.members, layer.members_ov))
            out.append((f"{name}.max", (layer.max_memberships,
                                        layer.max_hyperedge_size)))
        else:
            parts = (("out", layer.out, layer.out_ov), ("in", layer.in_, layer.in_ov))
            out.append((f"{name}.flags", (layer.directed, layer.valued,
                                          layer.allow_self, layer.store_inbound)))
        for part, c, ov in parts:
            out += csr(f"{name}.{part}", c)
            if ov is None:
                out.append((f"{name}.{part}_ov", None))
            else:
                out += csr(f"{name}.{part}_ov.delta", ov.delta)
                out += [(f"{name}.{part}_ov.dirty", ov.dirty),
                        (f"{name}.{part}_ov.dirty_host", ov.dirty_host),
                        (f"{name}.{part}_ov.base_shadowed", ov.base_shadowed)]
    return out


def assert_same_network(label: str, got, want) -> int:
    """Fails unless every buffer of ``got`` equals ``want``'s: the same
    names, dtypes, shapes and elements (``torch.equal`` on the buffers'
    device), the same scalars. Returns the bytes compared."""
    import torch

    a, b = net_buffers(got), net_buffers(want)
    if [k for k, _ in a] != [k for k, _ in b]:
        raise AssertionError(f"{label}: the networks hold different buffers")
    nbytes = 0
    for (key, x), (_, y) in zip(a, b):
        if isinstance(x, torch.Tensor) and isinstance(y, torch.Tensor):
            same = (x.dtype == y.dtype and x.shape == y.shape
                    and x.device == y.device
                    and torch.equal(tensor_bits(x), tensor_bits(y)))
            nbytes += x.nbytes
        elif isinstance(x, np.ndarray) and isinstance(y, np.ndarray):
            same = x.dtype == y.dtype and np.array_equal(x, y)
        else:
            same = type(x) is type(y) and x == y
        if not same:
            raise AssertionError(f"{label}: {key} differs")
    return nbytes


class PeakRss:
    """Within the block, the peak growth of this process's resident set
    over its size on entry: VmRSS sampled every 2 ms and read once more on
    exit, with the block's objects still alive."""

    @staticmethod
    def read() -> int:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) * 1024
        raise KeyError("VmRSS")

    def __enter__(self):
        import threading

        self.base = self.peak = self.read()
        self._stop = threading.Event()

        def sample():
            while not self._stop.wait(0.002):
                self.peak = max(self.peak, self.read())

        self._thread = threading.Thread(target=sample, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.growth = max(self.peak, self.read()) - self.base


def load_rss_child(path: str, mmap: bool, device: str) -> None:
    """One ``loadfile`` of ``path`` in this (fresh) interpreter, printing
    one JSON line: the peak host-RSS growth over the load, and what the
    load must allocate on the host: the ``indptr`` mirrors it keeps
    beside the device CSRs and, on a card, the pinned staging buffer.
    The device context exists and garbage is collected before the base
    reading, so the reading holds the load alone."""
    import gc

    import torch

    from repro_torch.core import api, io

    dev = torch.device(device)
    torch.ones(1, device=dev)
    gc.collect()
    gc.disable()
    with PeakRss() as rss:
        net = api.loadfile(path, mmap=mmap, device=dev)
        if dev.type == "cuda":
            torch.cuda.synchronize()
    gc.enable()
    csrs = [c for layer in net.layers
            for c in ((layer.memb, layer.members) if layer.mode == 2
                      else (layer.out, layer.in_)) if c is not None]
    print(json.dumps({
        "growth": rss.growth,
        "mirrors": sum(int(c.indptr_host.nbytes) for c in csrs),
        "staging": io.STAGING_BYTES if dev.type == "cuda" else 0,
    }), flush=True)


def load_rss(path: Path, mmap: bool, device) -> dict:
    """``load_rss_child`` in a fresh interpreter: a reading that no
    memory freed by earlier phases and reused by the load can lower."""
    code = (f"import sys; sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]; "
            f"import chip_smoke; chip_smoke.load_rss_child({str(path)!r}, {mmap!r}, "
            f"{str(device)!r})")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300, check=False)
    if out.returncode:
        raise RuntimeError(f"the load's RSS reading failed ({out.returncode}): "
                           f"{out.stderr[-2000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def register_ops(net, seed: int, device) -> tuple[list, dict]:
    """The batches of register changes (the REG_* recipe) drawn against the
    unmutated ``net`` -> ([(label, WAL op)], {layer: host ids of the nodes
    its ops touch}). Ops are ``core/wal.py``'s, so the same list goes
    through the api and through ``DurableStore.apply``."""
    import torch

    from repro_torch.core import wal
    from repro_torch.core.csr import take_ids

    rng = np.random.default_rng(seed + 40)
    n = net.n_nodes

    def first_ids(csr, nodes):
        pos = torch.from_numpy(csr.indptr_host[nodes].astype(np.int64)).to(device)
        return take_ids(csr.indices, pos).cpu().numpy().astype(np.int64)

    ops, touched = [], {}
    for name in ("Households", "Workplaces"):
        layer = net.layer(name)
        u = rng.choice(n, REG_MOVES, replace=False)
        u = u[np.diff(layer.memb.indptr_host)[u] > 0]
        ops += [(f"{name} moves: delete", wal.make_delete_edges_op(
                    name, u, first_ids(layer.memb, u))),
                (f"{name} moves: add", wal.make_add_edges_op(
                    name, u, rng.integers(0, layer.n_hyperedges, u.size)))]
        touched[name] = u
    wp = net.layer("Workplaces")
    u = rng.integers(0, n, REG_NEW_MEMBERS)
    ops.append(("Workplaces: 100 new groups", wal.make_add_edges_op(
        "Workplaces", u, wp.n_hyperedges + rng.integers(0, REG_NEW_GROUPS, u.size))))
    touched["Workplaces"] = np.union1d(touched["Workplaces"], u)
    a, b = rng.integers(0, n, (2, REG_RANDOM_ADDS))
    ops.append(("Random: new ties", wal.make_add_edges_op("Random", a, b)))
    out = net.layer("Random").out
    u = rng.choice(n, 2 * REG_RANDOM_DELETES, replace=False)
    u = u[np.diff(out.indptr_host)[u] > 0][:REG_RANDOM_DELETES]
    v = first_ids(out, u)
    ops.append(("Random: ended ties", wal.make_delete_edges_op("Random", u, v)))
    touched["Random"] = np.unique(np.concatenate([a, b, u, v]))
    sc = net.layer("Schools")
    u = rng.integers(0, n, REG_SCHOOL_JOINS)
    ops.append(("Schools: joins", wal.make_add_edges_op(
        "Schools", u, rng.integers(0, sc.n_hyperedges, u.size))))
    u2 = rng.integers(0, n, REG_NEW_MEMBERS)
    ops.append(("Schools: 100 new schools past uint16", wal.make_add_edges_op(
        "Schools", u2, REG_FIRST_NEW_SCHOOL + rng.integers(0, REG_NEW_GROUPS, u2.size))))
    touched["Schools"] = np.union1d(u, u2)
    u = rng.choice(n, REG_INCOME_UPDATES, replace=False)
    ops.append(("income: new values", wal.make_set_attr_op(
        "income", u, rng.integers(0, 100_000, u.size), kind="int")))
    return ops, touched


def apply_register_op(net, op):
    """One register op through the api call a user makes for it."""
    from repro_torch.core import api

    if op["op"] == "add_edges":
        return api.addedges(net, op["layer"], op["src"], op["dst"],
                            values=op.get("values"))
    if op["op"] == "delete_edges":
        return api.deleteedges(net, op["layer"], op["src"], op["dst"])
    if op["op"] == "set_attr":
        return api.setnodeattr(net, op["name"], op["nodes"], op["values"],
                               kind=op["kind"])
    raise ValueError(f"no register op {op['op']!r}")


def overlay_line(layer) -> tuple[int, int]:
    """(delta nnz, bytes uploaded: the delta CSRs and dirty masks) over
    the layer's live overlays."""
    if layer.mode == 2:
        ovs = (layer.memb_ov, layer.members_ov)
    else:
        ovs = (layer.out_ov, layer.in_ov)
    ovs = [ov for ov in ovs if ov is not None]
    return (sum(ov.delta.nnz for ov in ovs),
            sum(ov.delta.nbytes + int(ov.dirty.nbytes) for ov in ovs))


def mutate(net, ops, label: str, profile: bool = True):
    """``ops`` through the api, one at a time, each printed with its wall
    time (device busy and idle with ``profile``), delta nnz, overlay ratio,
    bytes uploaded and whether the layer compacted -> (net, [wall ms],
    {layer: compactions})."""
    from repro_torch.core.layers import has_overlay, layer_overlay_ratio

    walls, compactions = [], collections.Counter()
    for name, op in ops:
        layer_name = op.get("layer")
        before = (has_overlay(net.layer(layer_name)) if layer_name else False)
        if profile:
            ms, acts, net = profiled(lambda: apply_register_op(net, op))
            busy = busy_line(acts, ms, top=2)
        else:
            t0 = time.perf_counter()
            net = apply_register_op(net, op)
            ms, busy = (time.perf_counter() - t0) * 1e3, "not profiled"
        walls.append(ms)
        if layer_name is None:
            log(f"{label}: {name}: {len(op['nodes'])} nodes, {ms:.3f} ms, {busy}")
            continue
        layer = net.layer(layer_name)
        nnz, up = overlay_line(layer)
        compacted = not has_overlay(layer)
        compactions[layer_name] += compacted
        log(f"{label}: {name}: {len(op['src'])} pairs, {ms:.3f} ms, {busy}; delta "
            f"nnz {nnz}, overlay ratio {layer_overlay_ratio(layer):.4f}, "
            f"{up} bytes of overlay uploaded, compacted {compacted} (overlay "
            f"before: {before})")
    return net, walls, compactions


def storage_queries(net, touched: dict, seed: int, device) -> dict:
    """The phase's query inputs on the mutated network: getedge/checkedge
    pairs per layer (half the sources on rows the ops touched), alters and
    degree nodes (half touched) and the walk fleet's starts."""
    rng = np.random.default_rng(seed + 41)
    n, half = net.n_nodes, POINT_PAIRS // 2
    every = np.unique(np.concatenate(list(touched.values())))
    q = {}
    for name, _, _ in LAYER_RECIPE:
        mixed = np.concatenate([rng.choice(touched[name], half),
                                rng.integers(0, n, POINT_PAIRS - half)])
        q[f"edge/{name}"] = pair_ids(net.layer(name), n, POINT_PAIRS, rng, device,
                                     u=mixed)
    u = np.concatenate([rng.choice(touched["Random"], half),
                        rng.integers(0, n, POINT_PAIRS - half)])
    q["edge/Random"] = (u, rng.integers(0, n, POINT_PAIRS))
    q["alters"] = np.concatenate([rng.choice(every, ALTERS_NODES // 2),
                                  rng.integers(0, n, ALTERS_NODES // 2)])
    q["degree"] = np.concatenate([rng.choice(every, DEGREE_NODES // 2),
                                  rng.integers(0, n, DEGREE_NODES // 2)])
    q["walk"] = np.concatenate([rng.choice(touched["Workplaces"],
                                           STORAGE_WALK_STARTS // 2),
                                rng.integers(0, n, STORAGE_WALK_STARTS // 2)])
    return q


def storage_calls(net, q: dict, sel, seed: int) -> dict:
    """name -> call of the phase's queries on ``net`` through the api."""
    from repro_torch.core import api

    calls = {}
    for name in [nm for nm, _, _ in LAYER_RECIPE] + ["Random"]:
        u, v = q[f"edge/{name}"]
        calls[f"getedge {name} x{u.size}"] = (
            lambda net, name=name, u=u, v=v: api.getedge(net, name, u, v))
        calls[f"checkedge {name} x{u.size}"] = (
            lambda net, name=name, u=u, v=v: api.checkedge(net, name, u, v).cpu())
    calls[f"getnodealters x{q['alters'].size}, 4 layers"] = (
        lambda net: api.getnodealters(net, q["alters"], max_alters=MAX_ALTERS))
    calls[f"getdegree income > median x{q['degree'].size}"] = (
        lambda net: api.getdegree(net, q["degree"], filter=sel))
    calls[f"walkbatch Workplaces {q['walk'].size} x {STORAGE_WALK_STEPS} steps"] = (
        lambda net: api.walkbatch(net, q["walk"], STORAGE_WALK_STEPS, seed=seed + 42,
                                  layernames=["Workplaces"]))
    return calls


def same_result(a, b) -> bool:
    import torch

    if isinstance(a, tuple):
        return len(a) == len(b) and all(same_result(x, y) for x, y in zip(a, b))
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)
    if isinstance(a, np.ndarray):
        return a.dtype == b.dtype and np.array_equal(a, b)
    return a == b


def storage_plain_check(net, q: dict, nf, device) -> None:
    """ORACLE_QUERIES queries of each kind on the mutated network against
    the port's padded plain path, bit for bit (as the oracle phase)."""
    import torch

    from repro_torch.core import api
    from repro_torch.kernels import ref

    k, bad = ORACLE_QUERIES, []
    for name, _, _ in LAYER_RECIPE:
        u, v = (x[:k] for x in q[f"edge/{name}"])
        layer = net.layer(name)
        want = layer.edge_value_padded(torch.from_numpy(u.astype(np.int32)).to(device),
                                       torch.from_numpy(v.astype(np.int32)).to(device)).cpu()
        if not torch.equal(api.getedge(net, name, u, v), want):
            bad.append(f"getedge/{name}")
        if not torch.equal(api.checkedge(net, name, u, v).cpu(), want > 0):
            bad.append(f"checkedge/{name}")
    u = q["alters"][:k]
    ut = torch.from_numpy(u.astype(np.int32)).to(device)
    parts = [layer.node_alters_padded(ut, MAX_ALTERS)[0] if layer.mode == 2
             else layer.node_alters(ut, MAX_ALTERS)[0] for layer in net.layers]
    want, _ = ref.segmented_union_ref(torch.cat(parts, dim=-1), MAX_ALTERS)
    if not torch.equal(api.getnodealters(net, u, max_alters=MAX_ALTERS)[0], want.cpu()):
        bad.append("getnodealters")
    u = q["degree"][:k]
    ut = torch.from_numpy(u.astype(np.int32)).to(device)
    want = sum(layer.filtered_degree_padded(ut, nf).cpu().long() for layer in net.layers)
    if not np.array_equal(api.getdegree(net, u, filter=nf.cpu().numpy()), want.numpy()):
        bad.append("getdegree")
    if bad:
        raise AssertionError(f"storage: the overlay network's kernel path differs "
                             f"from the padded plain path: {bad}")


def storage_kernel_checks(net, touched: dict, union_rows, draws, seed: int,
                          device) -> str:
    """The three kernels on the overlays ``overlay_update`` wrote, each
    against its plain version on the same inputs, bit for bit:
    ``intersect_rows`` on pairs of touched nodes of each two-mode layer
    (unfiltered and filtered), ``csr_row_sample`` on touched and grown
    rows of each membership and member CSR and at every launch shape of
    the walk fleet, ``segmented_union`` on the heaviest launch of the
    alters call."""
    import torch

    from repro_torch.core import prng
    from repro_torch.core.dispatch import DEFAULT_BUCKET_WIDTHS
    from repro_torch.kernels import ops, ref

    rng = np.random.default_rng(seed + 43)
    k1, k2 = prng.split(prng.key(seed + 44))
    notes = []
    for name, _, _ in LAYER_RECIPE:
        layer = net.layer(name)
        if layer.memb_ov is None:
            notes.append(f"{name} compacted")
            continue
        u = torch.from_numpy(rng.choice(touched[name], ORACLE_QUERIES).astype(np.int32)).to(device)
        v = torch.from_numpy(rng.choice(touched[name], ORACLE_QUERIES).astype(np.int32)).to(device)
        nf = torch.from_numpy(rng.random(net.n_nodes) < 0.5).to(device)
        for f in (None, nf):
            got = ops.intersect_rows(layer.memb, layer.memb_ov, u, v, f,
                                     widths=DEFAULT_BUCKET_WIDTHS)
            want = ref.intersect_rows_ref(layer.memb, layer.memb_ov, u, v, f,
                                          DEFAULT_BUCKET_WIDTHS)
            exact_check(f"intersect_rows on {name}'s overlay", (got,), (want,))
        for part, base, ov in (("memb", layer.memb, layer.memb_ov),
                               ("members", layer.members, layer.members_ov)):
            dirty = np.flatnonzero(ov.dirty_host)
            rows = np.concatenate([rng.choice(dirty, 4096),
                                   rng.integers(0, ov.delta.n_rows, 4096)])
            rt = torch.from_numpy(rows.astype(np.int32)).to(device)
            exact_check(f"csr_row_sample on {name}.{part}'s overlay",
                        ops.csr_row_sample(base, ov, rt, k1, k2),
                        ref.csr_row_sample_ref(base, ov, rt, k1, k2))
        notes.append(
            f"{name}: memb {layer.memb.indices.dtype} base under a "
            f"{layer.memb_ov.delta.indices.dtype} delta, members "
            f"{layer.members.n_rows} base rows under {layer.members_ov.delta.n_rows}")
    for (kname, shape), (args, kwargs) in draws.first.items():
        exact_check(f"{kname} at {shape} in the walk fleet",
                    draw_kernel(kname, args, kwargs), draw_plain(kname, args, kwargs))
    flat, max_out = union_rows.heaviest[1]
    got = ops.segmented_union_cuda(flat, max_out)
    exact_check(f"segmented_union at {tuple(flat.shape)}", (got,),
                (ref.segmented_union_ref(flat, max_out)[0],))
    return "; ".join(notes) + (f"; {len(draws.first)} csr_row_sample launch shapes "
                               f"of the fleet; segmented_union at {tuple(flat.shape)}")


def storage_files(net, tmp: Path, card: str, device) -> Path:
    """Save and load: ``savefile(compress=False)``, then ``loadfile`` with
    and without ``mmap``; every loaded buffer must equal the network's.
    Each load's peak host-RSS growth is read alone (``load_rss``): it must
    reach the bytes the load allocates on the host, and the mmap load's
    must stay under the file's size. Returns the file."""
    from repro_torch.core import api

    path = tmp / "register.npz"
    t0 = time.perf_counter()
    api.savefile(net, str(path), compress=False)
    save_s = time.perf_counter() - t0
    size = path.stat().st_size
    log(f"storage: savefile(compress=False) {size} bytes in {save_s:.3f} s; {card}")
    for mmap in (True, False):
        sync()
        t0 = time.perf_counter()
        loaded = api.loadfile(str(path), mmap=mmap, device=device)
        sync()
        secs = time.perf_counter() - t0
        nbytes = assert_same_network(f"loadfile(mmap={mmap})", loaded, net)
        del loaded
        rss = load_rss(path, mmap, device)
        floor = rss["mirrors"] + rss["staging"]
        log(f"storage: loadfile(mmap={mmap}) {secs:.3f} s, {size / secs / 1e9:.3f} GB/s "
            f"of file; {nbytes} device bytes equal the network's; peak host-RSS "
            f"growth of the load alone {rss['growth']} bytes ({rss['growth'] / size:.3f} "
            f"of the file), floor {floor} (indptr mirrors {rss['mirrors']} + staging "
            f"{rss['staging']}); {card}")
        if rss["growth"] < floor:
            raise AssertionError(
                f"loadfile(mmap={mmap}): the host-RSS reading {rss['growth']} is below "
                f"the {floor} bytes the load allocates on the host")
        if mmap and rss["growth"] >= size:
            raise AssertionError(
                f"loadfile(mmap=True) grew the host RSS by {rss['growth']} bytes, not "
                f"less than the file's {size}")
    return path


def storage_store(base, mutated_compact, ops, tmp: Path, card: str, device) -> dict:
    """The durable store: ``DurableStore.create`` on ``base``, the same ops
    through ``apply``, ``close``, ``recovernet``; the recovered network's
    compacted buffers must equal ``mutated_compact``'s. Then the WAL cut in
    the middle of its last record must recover with ``torn_bytes > 0`` to
    the state before that op."""
    from repro_torch.core import api, wal
    from repro_torch.core.snapshot import WAL_NAME, DurableStore

    store_dir = tmp / "store"
    t0 = time.perf_counter()
    store = DurableStore.create(store_dir, base)
    create_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _, op in ops:
        store.apply(op)
    apply_s = time.perf_counter() - t0
    last = store.net
    store.close()
    t0 = time.perf_counter()
    rec, info = api.recovernet(str(store_dir), device=device)
    sync()
    recover_s = time.perf_counter() - t0
    if info["replayed"] != len(ops) or info["torn_bytes"]:
        raise AssertionError(f"storage: recovery replayed {info}")
    assert_same_network("recovered store, raw buffers", rec, last)
    t0 = time.perf_counter()
    nbytes = assert_same_network("recovered store, compacted", rec.compacted(),
                                 mutated_compact)
    compact_s = time.perf_counter() - t0
    log(f"storage: store of {base.n_nodes} nodes: create {create_s:.3f} s "
        f"(compressed snapshot {sum(p.stat().st_size for p in store_dir.glob('snap-*.npz'))}"
        f" bytes), apply {len(ops)} ops {apply_s:.3f} s, recovernet {recover_s:.3f} s "
        f"({json.dumps(info)}), compacted() and compare {compact_s:.3f} s: "
        f"{nbytes} device bytes equal the directly mutated network's; {card}")
    log_path = store_dir / WAL_NAME
    records, end, _ = wal.scan(log_path)
    cut = records[-1].offset + (records[-1].end_offset - records[-1].offset) // 2
    with open(log_path, "r+b") as f:
        f.truncate(cut)
    t0 = time.perf_counter()
    torn, tinfo = api.recovernet(str(store_dir), device=device)
    sync()
    torn_s = time.perf_counter() - t0
    if not (tinfo["torn_bytes"] > 0 and tinfo["replayed"] == len(ops) - 1):
        raise AssertionError(f"storage: torn WAL recovered {tinfo}")
    # the last op sets incomes: before it, the final layers and base's nodeset
    if ops[-1][1]["op"] != "set_attr":
        raise AssertionError("storage: the register ops must end with the income op")
    assert_same_network("torn WAL recovery", torn, last.with_nodeset(base.nodeset))
    log(f"storage: WAL cut at byte {cut} of {end} (inside lsn {records[-1].lsn}): "
        f"recovered in {torn_s:.3f} s with {json.dumps(tinfo)}, equal to the "
        f"state before the last op; {card}")
    return {"create_s": create_s, "apply_s": apply_s, "recover_s": recover_s}


def cli_op_line(op: dict) -> str:
    """A register op (``core/wal.py``'s) as the CLI command a user types."""
    def ids(xs):
        return ";".join(map(str, xs))

    if op["op"] == "set_attr":
        return (f"setattr(net, {op['name']}, {ids(op['nodes'])}, {ids(op['values'])}, "
                f"kind = {op['kind']})")
    cmd = {"add_edges": "addedges", "delete_edges": "deleteedges"}[op["op"]]
    line = f"{cmd}(net, {op['layer']}, src = {ids(op['src'])}, dst = {ids(op['dst'])}"
    if op.get("values") is not None:
        line += f", values = {ids(op['values'])}"
    return line + ")"


def cli_picks(size: int) -> np.ndarray:
    """CLI_QUERIES positions of a query batch of ``size``: the first half
    (on rows the batches touched) and the last (drawn over all nodes)."""
    k = CLI_QUERIES // 2
    return np.r_[0:k, size - (CLI_QUERIES - k):size]


def storage_cli(path: Path, ops, q: dict, outs: dict, sel, median_income: int,
                mutated, card: str, device) -> dict:
    """A JSON-mode script through ``Session()`` on the card: ``loadfile``
    (mmap) of the saved file, the same batches as ``addedges`` /
    ``deleteedges`` / ``setattr`` commands, then checkedge on each layer,
    getnodealters, the filtered getdegree and khop on CLI_QUERIES inputs
    of the overlay queries (``q``). Its network must equal ``mutated``, its
    outputs the overlay queries' (``outs``; khop the api's on ``mutated``),
    and with launch counts reset just before and read just after,
    ``intersect_rows``, ``segmented_union`` and ``frontier_compact`` must
    launch. Returns the script's launch counts."""
    from repro_torch.core import api
    from repro_torch.core.cli import Session
    from repro_torch.kernels import build

    lines = [f'net = loadfile(file = "{path}", mmap = true)']
    lines += [cli_op_line(op) for _, op in ops]
    lines.append(f'sel = selectnodes(net, attr = income, op = ">", value = {median_income})')
    want = [{"count": sel.count}]
    for name in [nm for nm, _, _ in LAYER_RECIPE] + ["Random"]:
        u, v = q[f"edge/{name}"]
        got = outs[f"checkedge {name} x{u.size}"]
        for i in cli_picks(u.size):
            lines.append(f"checkedge(net, {name}, {u[i]}, {v[i]})")
            want.append(bool(got[i]))
    nodes = q["alters"]
    vals, mask = outs[f"getnodealters x{nodes.size}, 4 layers"]
    for i in cli_picks(nodes.size):
        lines.append(f"getnodealters(net, {nodes[i]}, max_alters = {MAX_ALTERS})")
        want.append(vals[i][mask[i]].tolist())
    nodes = q["degree"]
    got = outs[f"getdegree income > median x{nodes.size}"]
    for i in cli_picks(nodes.size):
        lines.append(f"getdegree(net, {nodes[i]}, filter = sel)")
        want.append(int(got[i]))
    sources = q["alters"][cli_picks(q["alters"].size)]
    lines.append("khop(net, " + ";".join(map(str, sources))
                 + ", k = 2, layernames = Households)")
    want.append(json.loads(json.dumps(
        api.khop(mutated, sources, 2, layernames=["Households"]), default=int)))
    session = Session(mode="json", device=device)
    build.launch_counts.clear()
    t0 = time.perf_counter()
    outputs = [json.loads(o) for o in session.run_script("\n".join(lines))]
    sync()
    secs = time.perf_counter() - t0
    launches = dict(build.launch_counts)
    got = [o["result"] for o in outputs]
    if got != want:
        bad = [i for i, (g, w) in enumerate(zip(got, want)) if g != w]
        raise AssertionError(f"storage: CLI outputs {bad} of {len(want)} differ from "
                             f"the overlay queries' ({len(got)} outputs)")
    nbytes = assert_same_network("storage: the CLI's network", session.env["net"], mutated)
    assert_launched("storage CLI", launches,
                    ("intersect_rows", "segmented_union", "frontier_compact"))
    log(f"storage: CLI script of {len(lines)} lines ({len(ops)} batches) on "
        f"{device} in {secs:.3f} s: its network equals the directly mutated one "
        f"({nbytes} device bytes), {len(want)} outputs equal the overlay queries' "
        f"and the api's khop; launch counts {json.dumps(launches, sort_keys=True)}; "
        f"{card}")
    return launches


def storage_cli_store(path: Path, tmp: Path, card: str, device) -> None:
    """A JSON-mode script through ``Session()`` on the card: ``loadfile``
    (mmap) of ``path``, ``savestore``, ``recovernet`` and ``wallog``; the
    recovered network must equal the loaded one."""
    from repro_torch.core.cli import Session

    store = tmp / "cli_store"
    lines = [f'net = loadfile(file = "{path}", mmap = true)',
             f'savestore(net, dir = "{store}")', f'rec = recovernet(dir = "{store}")',
             f'wallog(dir = "{store}")']
    session = Session(mode="json", device=device)
    t0 = time.perf_counter()
    outs = [json.loads(o) for o in session.run_script("\n".join(lines))]
    sync()
    secs = time.perf_counter() - t0
    rec, log_rows = outs[-2]["result"], outs[-1]["result"]
    if rec["snapshot_lsn"] != -1 or rec["torn_bytes"] or log_rows != []:
        raise AssertionError(f"storage: CLI store recovered {rec}, wallog {log_rows}")
    assert_same_network("storage: the CLI's recovered store", session.env["rec"],
                        session.env["net"])
    log(f"storage: CLI store script of {len(lines)} lines on {device} in {secs:.3f} s: "
        f"savestore + recovernet {json.dumps(rec)}, equal to the loaded network; "
        f"wallog {log_rows}; {card}")


def phase_storage(net, median_income: int, seed: int, device) -> dict:
    """Files, mutation, durability and the CLI on the phase's network:
    save and load (every buffer equal; the mmap load's peak host-RSS growth
    under the file's size), batches of register changes through the api,
    the queries on the overlays with launch counts set to 0 just before
    and read just after (``intersect_rows``, ``segmented_union`` and
    ``csr_row_sample`` must launch, on overlays ``overlay_update`` wrote,
    and equal their plain versions there), every query equal to the same
    query on ``compacted()`` and ORACLE_QUERIES of each kind to the padded
    plain path, the CLI on the saved file with the same batches and
    inputs of those queries, the durable store and the CLI's store
    commands. Returns the launch counts of the queries and of the CLI
    script."""
    import tempfile

    import torch

    from repro_torch.core import api
    from repro_torch.core.layers import DEFAULT_COMPACT_RATIO
    from repro_torch.kernels import build

    t_phase = time.perf_counter()
    card = device_line()
    with tempfile.TemporaryDirectory(prefix="threadle-storage-") as tmpname:
        tmp = Path(tmpname)
        path = storage_files(net, tmp, card, device)
        ops, touched = register_ops(net, seed, device)
        mutated, walls, compactions = mutate(net, ops, "storage: mutation")
        log(f"storage: mutation: {len(ops)} ops in {sum(walls):.3f} ms; "
            f"compactions by the compact-ratio policy "
            f"({DEFAULT_COMPACT_RATIO}): {json.dumps(dict(compactions))}; {card}")
        sel = api.selectnodes(mutated, "income", ">", median_income)
        q = storage_queries(mutated, touched, seed, device)
        calls = storage_calls(mutated, q, sel, seed)
        outs, lat = {}, {}
        build.launch_counts.clear()
        with Launches("segmented_union_cuda",
                      lambda flat, max_out: 4 * flat.shape[0] * (flat.shape[1] + max_out),
                      lambda flat, max_out: tuple(flat.shape)) as union_rows, \
                DrawInputs() as draws:
            for name, call in calls.items():
                ms, outs[name] = host_median_ms(lambda: call(mutated), STORAGE_REPEATS)
                lat[name] = ms
                log(f"storage: overlay {name}: median {ms:.3f} ms; {card}")
            sync()
        launches = dict(build.launch_counts)
        log(f"storage: launch counts {json.dumps(launches, sort_keys=True)}")
        assert_launched("storage", launches,
                        ("intersect_rows", "segmented_union", "csr_row_sample"))
        assert_no_sort_rows("storage", launches)
        t0 = time.perf_counter()
        compact = mutated.compacted()
        sync()
        compact_s = time.perf_counter() - t0
        log(f"storage: Network.compacted() {compact_s:.3f} s; {card}")
        clat = {}
        for name, call in calls.items():
            ms, out = host_median_ms(lambda: call(compact), STORAGE_REPEATS)
            clat[name] = ms
            if not same_result(outs[name], out):
                raise AssertionError(f"storage: {name} on the overlays differs from "
                                     "the same query on compacted()")
            log(f"storage: compacted {name}: median {ms:.3f} ms (overlay "
                f"{lat[name]:.3f} ms); equal; {card}")
        storage_plain_check(mutated, q, sel.device_mask(device), device)
        note = storage_kernel_checks(mutated, touched, union_rows, draws, seed, device)
        log(f"storage: each query on the overlays equals compacted()'s; "
            f"{ORACLE_QUERIES} of each kind equal the padded plain path; the "
            f"kernels equal their plain versions on the port's overlays ({note})")
        store_compact = compact if STORE_NODES == net.n_nodes else None
        del compact, calls
        cli_launches = storage_cli(path, ops, q, outs, sel, median_income, mutated,
                                   card, device)
        del outs, mutated
        if STORE_NODES == net.n_nodes:
            store_base, store_ops, cli_path = net, ops, path
        else:
            t0 = time.perf_counter()
            store_base, _ = build_network(STORE_NODES, seed, device)
            store_ops, _ = register_ops(store_base, seed, device)
            small, _, _ = mutate(store_base, store_ops, "storage: store mutation",
                                 profile=False)
            store_compact = small.compacted()
            cli_path = tmp / "store_net.npz"
            api.savefile(store_base, str(cli_path), compress=False)
            log(f"storage: store network of {STORE_NODES} nodes (cut), built, "
                f"mutated, compacted and saved in {time.perf_counter() - t0:.3f} s")
        storage_store(store_base, store_compact, store_ops, tmp, card, device)
        storage_cli_store(cli_path, tmp, card, device)
    torch.cuda.empty_cache()
    log(f"storage: phase {time.perf_counter() - t_phase:.3f} s; {card}")
    return {"launches": launches, "cli_launches": cli_launches}



def serve_slo():
    """``benchmarks/torch_serve_slo.py``: the serving trace and the wire's
    load generators."""
    bench = str(ROOT / "benchmarks")
    if bench not in sys.path:
        sys.path.insert(0, bench)
    import torch_serve_slo

    return torch_serve_slo


class ServeThreads:
    """Within the block, wraps the engine's executors, ``Nodeset.select``
    and the api's mutations: the threads the queries and the mutations
    ran on, and the launch counts each request kind's dispatches added.
    Counts nothing itself."""

    MUTATIONS = ("addedges", "deleteedges", "setnodeattr", "deletelayer")

    def __init__(self):
        self.threads = collections.Counter()
        self.mutations = collections.Counter()
        self.by_kind = collections.defaultdict(collections.Counter)

    def __enter__(self):
        import threading

        from repro_torch.core import api
        from repro_torch.core.nodeset import Nodeset
        from repro_torch.kernels import build
        from repro_torch.serve import graph_engine as ge

        self._real = dict(ge._EXECUTORS)
        self._select = Nodeset.select
        self._api = {name: getattr(api, name) for name in self.MUTATIONS}

        def mutation(real):
            def call(*args, **kw):
                self.mutations[threading.get_ident()] += 1
                return real(*args, **kw)
            return call

        for name, real in self._api.items():
            setattr(api, name, mutation(real))

        def wrap(kind, real):
            def call(net, group_key, creqs):
                self.threads[threading.get_ident()] += 1
                before = collections.Counter(build.launch_counts)
                out = real(net, group_key, creqs)
                self.by_kind[kind].update(build.launch_counts - before)
                return out
            return call

        for kind, real in self._real.items():
            ge._EXECUTORS[kind] = wrap(kind, real)
        real_select = self._select

        def select(ns, *args, **kw):
            self.threads[threading.get_ident()] += 1
            return real_select(ns, *args, **kw)

        Nodeset.select = select
        return self

    def __exit__(self, *exc):
        from repro_torch.core import api
        from repro_torch.core.nodeset import Nodeset
        from repro_torch.serve import graph_engine as ge

        ge._EXECUTORS.update(self._real)
        Nodeset.select = self._select
        for name, real in self._api.items():
            setattr(api, name, real)


def kind_line(by_kind: dict) -> str:
    return "; ".join(f"{kind} {json.dumps(dict(c), sort_keys=True)}"
                     for kind, c in sorted(by_kind.items()))


def wire_value(value):
    """A served value as a client receives it: JSON round-tripped."""
    from repro_torch.serve.graph_engine import _pythonic

    return json.loads(json.dumps(_pythonic(value)))


def graph_launches(counts) -> int:
    """Kernel launches among launch counts (the plain sorts' counts are
    not launches)."""
    return sum(v for k, v in counts.items() if k in GRAPH_KERNEL_SYMBOLS)


def graph_kernel_events(acts: dict) -> int:
    """Device events of the graph kernels among profiled activities
    ({name: [events, microseconds]})."""
    import re

    pattern = re.compile(
        r"\b(" + "|".join(sorted({sym for syms in GRAPH_KERNEL_SYMBOLS.values()
                                   for sym in syms})) + r")\b")
    return sum(n for name, (n, _) in acts.items() if pattern.search(name))


def launch_threads(prof) -> collections.Counter:
    """The threads that made the CUDA launches and copies the profiler
    saw: {thread id: events}, runtime API events only. Kineto files such
    an event under the native id of a thread it has registered, else under
    the low 32 bits of the thread's ``threading.get_ident()`` as a signed
    int; the profiler's own ``thread`` field numbers threads its own way
    and reads the same for every thread."""
    import torch

    names = ("cudaLaunchKernel", "cuLaunchKernel", "cudaMemcpy", "cudaMemset",
             "cudaLaunchKernelExC")
    out = collections.Counter()
    for ev in prof.profiler.kineto_results.events():
        if (ev.device_type() == torch.autograd.DeviceType.CPU
                and ev.name().startswith(names)):
            out[ev.device_resource_id()] += 1
    return out


def thread_ids(thread) -> set:
    """The ids ``launch_threads`` may file ``thread``'s events under."""
    low = thread.ident & 0xFFFFFFFF
    return {thread.native_id, low, low - (1 << 32) if low >> 31 else low}


def serving_oracle(net, trace, values, median_income, device) -> None:
    """ORACLE_QUERIES requests of each trace kind (the first of each in
    the trace) against the port's plain paths on the card, bit for bit: getedge on the padded
    intersection, alters on the padded union and the plain dedup, degree on
    the per-layer degrees, k-hop with the plain compaction and merge
    (``use_kernel=False``), walks with the plain row sample."""
    import torch

    from repro_torch.core import api
    from repro_torch.core.traversal import khop_neighborhood, khop_records
    from repro_torch.kernels import ops, ref
    from repro_torch.serve import assert_results_equal, run_request

    slo = serve_slo()
    picks = collections.defaultdict(list)
    for i, req in enumerate(trace):
        if len(picks[slo.trace_kind(req)]) < ORACLE_QUERIES:
            picks[slo.trace_kind(req)].append(i)
    nf = api.selectnodes(net, "income", ">", median_income).device_mask(device)
    bad = []

    def ids_of(idx, key):
        return torch.tensor([trace[i][key] for i in idx], dtype=torch.int32,
                            device=device)

    for kind in ("getedge", "fgetedge"):
        idx = picks[kind]
        layer = net.layer(trace[idx[0]]["layer"])
        want = layer.edge_value_padded(
            ids_of(idx, "u"), ids_of(idx, "v"),
            node_filter=nf if kind == "fgetedge" else None).cpu().numpy()
        if [float(w) for w in want] != [values[i] for i in idx]:
            bad.append(kind)
    for kind in ("alters", "falters"):
        idx = picks[kind]
        req = trace[idx[0]]
        ut, m, mask = ids_of(idx, "u"), req["max_alters"], (
            nf if kind == "falters" else None)
        parts = [
            layer.node_alters_padded(ut, m, node_filter=mask)[0] if layer.mode == 2
            else layer.node_alters(ut, m, node_filter=mask)[0]
            for layer in (net.layer(name) for name in req["layers"])]
        want, wmask = ref.segmented_union_ref(torch.cat(parts, dim=-1), m)
        want, wmask = want.cpu().numpy(), wmask.cpu().numpy()
        if any(not np.array_equal(want[j][wmask[j]], values[i])
               for j, i in enumerate(idx)):
            bad.append(kind)
    idx = picks["degree"]
    ut = ids_of(idx, "u").long()
    want = sum(layer.degrees()[ut].cpu().long() for layer in net.layers).tolist()
    if want != [values[i] for i in idx]:
        bad.append("degree")
    idx = picks["khop"]
    req = trace[idx[0]]
    src = [trace[i]["sources"] for i in idx]
    nodes, mask, hops = khop_neighborhood(
        net, np.asarray(src, np.int32), req["k"], max_frontier=req["max_frontier"],
        layer_names=req["layers"], use_kernel=False)
    records = khop_records(src, nodes, mask, hops)
    try:
        for j, i in enumerate(idx):
            assert_results_equal(values[i], records[j : j + 1])
    except AssertionError:
        bad.append("khop")
    kernel = ops.csr_row_sample
    ops.csr_row_sample = ref.csr_row_sample_ref
    try:
        for i in picks["walkbatch"]:
            if not np.array_equal(run_request(net, trace[i]), values[i]):
                bad.append("walkbatch")
                break
    finally:
        ops.csr_row_sample = kernel
    if bad:
        raise AssertionError(f"serving: served results differ from the plain "
                             f"paths: {bad}")
    log(f"serving: oracle: {ORACLE_QUERIES} requests of each trace kind "
        f"({', '.join(sorted(picks))}) bit-identical to the plain paths on "
        "the card")


def serving_engine(net, trace, median_income, card: str, device) -> dict:
    """(a) the engine against the loop of single calls, through
    ``api.serve`` (timed) and the same engine again under the profiler."""
    from repro_torch.core import api
    from repro_torch.serve import assert_results_equal, run_request

    slo = serve_slo()
    n = len(trace)
    idx = range(0, n, SERVE_LOOP_STRIDE)
    loop_out, kind_s, kind_n = {}, collections.Counter(), collections.Counter()
    t0 = time.perf_counter()
    for i in idx:  # each call ends in its results' host copy
        t1 = time.perf_counter()
        loop_out[i] = run_request(net, trace[i])
        kind = slo.trace_kind(trace[i])
        kind_s[kind] += time.perf_counter() - t1
        kind_n[kind] += 1
    sync()
    loop_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    records, stats = api.serve(net, trace, cache_size=SERVE_CACHE)
    sync()
    serve_s = time.perf_counter() - t0
    loop_qps, serve_qps = len(idx) / loop_s, n / serve_s
    cut = "" if SERVE_LOOP_STRIDE == 1 else f" (every {SERVE_LOOP_STRIDE}th request, cut)"
    log(f"serving: (a) loop of single calls{cut}: {len(idx)} requests in "
        f"{loop_s:.3f} s, {loop_qps:.1f} requests/s; api.serve: {n} in "
        f"{serve_s:.3f} s, {serve_qps:.1f} requests/s; engine/loop "
        f"{serve_qps / loop_qps:.2f}x (the reference's target >= "
        f"{SERVE_TARGET_RATIO:g}x, printed, not gated); {card}")
    log("serving: (a) loop ms a request by kind: " + ", ".join(
        f"{k} {kind_s[k] / kind_n[k] * 1e3:.3f} (x{kind_n[k]})" for k in sorted(kind_n)))
    # the same engine run again under the profiler; a window that lost
    # device events (fewer graph-kernel events than launches counted) is
    # profiled again, up to PROFILER_WINDOWS runs, else not reported
    for window in range(1, PROFILER_WINDOWS + 1):
        engine = net.serve_session(cache_size=SERVE_CACHE)
        with ServeThreads() as watch:
            wall, acts, served = profiled(lambda: engine.serve(trace))
        errors = [r.error for r in served if r.error is not None]
        if errors:
            raise AssertionError(f"serving: (a) {len(errors)} error results, first "
                                 f"{errors[0]}")
        for i in idx:
            assert_results_equal(served[i].value, loop_out[i])
        if [r.to_record() for r in served] != records or engine.stats != stats:
            raise AssertionError("serving: (a) the engine's records or stats differ "
                                 "from api.serve's on the same trace")
        launched = graph_launches(sum(watch.by_kind.values(), collections.Counter()))
        delivered = graph_kernel_events(acts)
        if delivered >= launched:
            break
    busy = h2d = None
    if delivered >= launched:
        busy = sum(us for _, us in acts.values()) / 1e3
        h2d = sum(us for name, (_, us) in acts.items() if "HtoD" in name) / 1e3
        device_text = (busy_line(acts, wall, top=6) + f"; host-to-device copies "
                       f"{h2d:.3f} ms, {h2d / busy if busy else 0.0:.4f} of busy")
    else:
        device_text = "device busy not measured (every window lost events)"
    rs = engine.round_stats
    cache = stats["cache"]
    batches = sum(stats["batches"].values())
    log(f"serving: (a) {n} served results, 0 errors; the {len(idx)} of the loop "
        f"bit-identical to its single calls; cache hits {cache['hits']}, coalesced duplicates "
        f"{stats['coalesced_dupes']} ({(cache['hits'] + stats['coalesced_dupes']) / n:.3f} "
        f"of requests), batches {json.dumps(stats['batches'])}, "
        f"{sum(stats['dispatched'].values()) / batches:.2f} requests a batch, "
        f"{rs['rounds']} rounds, host {rs['round_s'] / rs['rounds'] * 1e3:.3f} ms a round")
    log(f"serving: (a) profiled engine run (window {window} of at most "
        f"{PROFILER_WINDOWS}): wall {wall:.3f} ms, {delivered} graph-kernel events "
        f"for {launched} launches, {device_text}; {card}")
    log(f"serving: (a) launches per kind: {kind_line(watch.by_kind)}")
    values = [r.value for r in served]
    return {"loop": loop_out, "values": values, "loop_qps": loop_qps,
            "serve_qps": serve_qps, "stats": stats, "wall_ms": wall,
            "busy_ms": busy, "h2d_ms": h2d, "by_kind": dict(watch.by_kind)}


def wire_mutation(address, at: float, out: dict) -> None:
    """At ``time.monotonic()`` ``at``, one attribute write over the wire
    through a client of its own: SERVE_PROBE_ATTR of SERVE_PROBE_NODES set
    to 1, 2, ...; the response, its round trip (ms) or the error in
    ``out``."""
    from repro_torch.serve import GraphServeClient, RetryPolicy

    try:
        time.sleep(max(0.0, at - time.monotonic()))
        retry = RetryPolicy(max_attempts=8, base=0.002, cap=0.05)
        with GraphServeClient(*address, retry=retry,
                              seed=SERVE_MUTATION_SEED) as client:
            t0 = time.perf_counter()
            out["response"] = client.mutate("setattr", {
                "name": SERVE_PROBE_ATTR, "nodes": list(SERVE_PROBE_NODES),
                "values": list(range(1, len(SERVE_PROBE_NODES) + 1))},
                deadline_ms=SERVE_DEADLINE_MS)
            out["ms"] = (time.perf_counter() - t0) * 1e3
    except Exception as err:  # reported by the caller
        out["error"] = err


def serving_wire(net, trace, values: list, card: str, device) -> dict:
    """(b) the wire: capacity from a closed loop, then the open loop at
    SERVE_LOAD of it under the reference's fault burst, profiled, with
    one attribute write sent half way through it; every wire result
    against (a)'s, the write read back, and every query, mutation and
    CUDA launch or copy on the engine's pump thread."""
    import threading

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import api
    from repro_torch.kernels import build

    slo = serve_slo()
    n = len(trace)
    plan = slo.default_fault_plan(n)
    distinct = len({json.dumps(r, sort_keys=True) for r in trace})
    cache = max(SERVE_CACHE, 1 << (distinct - 1).bit_length())
    fe = api.servenet(net, port=0, fault_plan=plan, cache_size=cache)
    wrote: dict = {}
    try:
        with ServeThreads() as watch:
            cap = slo.run_closed_loop(fe.address, trace[:SERVE_CAPACITY_REQUESTS],
                                      n_threads=SERVE_CLIENTS,
                                      deadline_ms=SERVE_DEADLINE_MS)
            plan.reset()  # the burst counts from the open loop's start
            rate = SERVE_LOAD * cap["qps"]
            before = collections.Counter(build.launch_counts)
            writer = threading.Thread(target=wire_mutation, args=(
                fe.address, time.monotonic() + n / (2 * rate), wrote))
            with warnings.catch_warnings():
                warnings.filterwarnings("ignore", message=".*Profiler clears events")
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    writer.start()
                    res = slo.run_open_loop(fe, trace, rate=rate,
                                            n_threads=SERVE_CLIENTS,
                                            deadline_ms=SERVE_DEADLINE_MS)
                    writer.join()
                    sync()
            launched = graph_launches(build.launch_counts - before)
        pump = fe.engine.pump_thread
        ping = api.pingnet(*fe.address)
        engine_stats = fe.engine.stats
        rs = fe.engine.round_stats
        served_net = fe.engine.net
    finally:
        fe.close()
    cap_errors = [o for o in cap["outcomes"] if o[0] != "ok"]
    log(f"serving: (b) capacity: closed loop of {SERVE_CAPACITY_REQUESTS} requests "
        f"over {SERVE_CLIENTS} sessions in {cap['wall_s']:.3f} s, "
        f"{cap['qps']:.1f} requests/s ({len(cap_errors)} errors); result cache "
        f"{cache}; {card}")
    log(f"serving: (b) open loop at {rate:.1f} requests/s ({SERVE_LOAD} of "
        f"capacity), one setattr over the wire half way: p50 {res['p50_ms']:.3f} ms, "
        f"p90 {res['p90_ms']:.3f} ms, p99 "
        f"{res['p99_ms']:.3f} ms (the reference's budget {SERVE_P99_BUDGET_MS:g} ms, "
        f"printed, not gated), max {res['max_ms']:.3f} ms; achieved "
        f"{res['qps']:.1f} requests/s; errors {res['errors']}; faults fired "
        f"{res['faults_fired']}, torn writes {res['torn_writes']}, idempotent "
        f"replays {res['idempotent_replays']}, shed {res['shed']}; engine pump "
        f"{rs['rounds']} rounds, host {rs['round_s']:.3f} s in rounds, waited "
        f"{rs['pump_wait_s']:.3f} s for work; {card}")
    if res["errors"] or cap_errors or engine_stats["pump_faults"]:
        first = next((o[1] for o in res["outcomes"] if o[0] != "ok"), None)
        raise AssertionError(f"serving: (b) errors on the wire: {res['error_kinds']} "
                             f"(first: {first}), {cap_errors[:1]}, pump faults "
                             f"{engine_stats['pump_faults']}")
    if res["faults_fired"] < 1 or res["idempotent_replays"] < 1:
        raise AssertionError("serving: (b) the fault burst never fired or no torn "
                             "ack was replayed")
    if not (ping["ok"] and ping["ready"]):
        raise AssertionError(f"serving: (b) not ready after the burst: {ping}")
    if "error" in wrote or not wrote["response"].get("ok"):
        raise AssertionError(f"serving: (b) the wire's setattr failed: {wrote}")
    probe, has = api.getnodeattr(served_net, SERVE_PROBE_ATTR, list(SERVE_PROBE_NODES))
    if not has.all() or probe.tolist() != list(range(1, len(SERVE_PROBE_NODES) + 1)):
        raise AssertionError(f"serving: (b) the acknowledged setattr does not read "
                             f"back: {probe.tolist()}, present {has.tolist()}")
    wrong = [i for i, (status, got) in enumerate(res["outcomes"])
             if status != "ok" or got != wire_value(values[i])]
    wrong += [i for i, (status, got) in enumerate(cap["outcomes"])
              if got != wire_value(values[i])]
    if wrong:
        raise AssertionError(f"serving: (b) {len(wrong)} wire results differ from "
                             f"(a)'s, first at request {wrong[0]}")
    off_pump = {t: k for t, k in watch.threads.items() if t != pump.ident}
    if off_pump or not watch.threads:
        raise AssertionError(f"serving: (b) executors or filter resolution off the "
                             f"pump thread: {off_pump}")
    if set(watch.mutations) != {pump.ident}:
        raise AssertionError(f"serving: (b) the wire's mutation ran on threads "
                             f"{dict(watch.mutations)}, not the pump thread")
    tids = launch_threads(prof)
    delivered = graph_kernel_events(device_events(prof))
    if set(tids) - thread_ids(pump):
        raise AssertionError(
            f"serving: (b) CUDA launches or copies off the pump thread (ids "
            f"{sorted(thread_ids(pump))}) in the open-loop window: {dict(tids)}")
    if not tids:
        how = "the profiler gave no runtime events"
    else:
        how = (f"the profiler's runtime events: {sum(tids.values())} launches and "
               f"copies, all filed under the pump thread's ids "
               f"({', '.join(str(t) for t in sorted(tids))})")
        if delivered < launched:
            how += (f", from a window that lost events ({delivered} graph-kernel "
                    f"events of {launched} launches)")
    log(f"serving: (b) {n} wire results (JSON round trip) equal (a)'s; "
        f"{SERVE_CAPACITY_REQUESTS} of the closed loop too; ready afterwards "
        f"(ping {ping['latency_ms']:.3f} ms); the setattr acknowledged in "
        f"{wrote['ms']:.3f} ms and read back; in both loops every "
        f"executor call and filter resolution ran on the pump thread "
        f"({sum(watch.threads.values())} calls), and the setattr too; {how}")
    return {"capacity_qps": cap["qps"], "rate": rate, "setattr_ms": wrote["ms"], **{
        k: res[k] for k in ("p50_ms", "p90_ms", "p99_ms", "max_ms", "qps",
                            "faults_fired", "idempotent_replays", "torn_writes")}}


def serving_mutations(net, trace, card: str) -> dict:
    """(c) the mutating replay: SERVE_MUTATIONS mutations interleaved in
    the trace, one engine with scoped invalidation and one without; every
    result equal between the two, scoped misses at most global ones."""
    from repro_torch.core import api
    from repro_torch.serve import GraphServeEngine, assert_results_equal

    n = net.n_nodes
    aux = np.random.default_rng(SERVE_AUX_SEED).integers(0, 100, n)
    base = api.setnodeattr(net, "aux", np.arange(n), aux, kind="int")
    rng = np.random.default_rng(SERVE_MUTATION_SEED)
    mutations = []
    for i in range(SERVE_MUTATIONS):
        if i % 2 == 0:
            mutations.append(("add_edges", "Random", rng.integers(0, n, 4),
                              rng.integers(0, n, 4)))
        else:
            mutations.append(("set_attr", "aux", rng.integers(0, n, 4),
                              rng.integers(0, 100, 4)))
    chunk = max(1, len(trace) // SERVE_MUTATIONS)

    def replay(scoped: bool):
        engine = GraphServeEngine(base, cache_size=SERVE_CACHE,
                                  scoped_invalidation=scoped)
        out, serve_s, walls = [], 0.0, []
        for mi, start in enumerate(range(0, len(trace), chunk)):
            t0 = time.perf_counter()
            out.extend(engine.serve(trace[start:start + chunk]))
            serve_s += time.perf_counter() - t0
            if mi < len(mutations):
                kind, name, a, b = mutations[mi]
                t0 = time.perf_counter()
                getattr(engine, kind)(name, a, b)
                sync()
                walls.append((kind, time.perf_counter() - t0))
        return out, serve_s, walls, engine.stats

    runs = {scoped: replay(scoped) for scoped in (True, False)}
    (out_s, s_s, walls_s, st_s), (out_g, s_g, walls_g, st_g) = runs[True], runs[False]
    errors = [r.error for r in out_s + out_g if r.error is not None]
    if errors or len(out_s) != len(trace):
        raise AssertionError(f"serving: (c) {len(errors)} error results: {errors[:1]}")
    for a, b in zip(out_s, out_g):
        assert_results_equal(a.value, b.value)
    out = {}
    for label, st, serve_s, walls in (("scoped", st_s, s_s, walls_s),
                                      ("global", st_g, s_g, walls_g)):
        c = st["cache"]
        hit = (c["hits"] + st["coalesced_dupes"]) / len(trace)
        by = collections.defaultdict(list)
        for kind, w in walls:
            by[kind].append(w * 1e3)
        out[label] = {"misses": c["misses"], "hits": c["hits"], "hit_rate": hit}
        log(f"serving: (c) {label} invalidation: {len(trace)} requests in "
            f"{serve_s:.3f} s of serving, hits {c['hits']}, misses {c['misses']}, "
            f"hit rate {hit:.4f}, entries invalidated {c['entries_invalidated']}; "
            f"mutation walls ms: " + ", ".join(
                f"{kind} x{len(ws)} median {statistics.median(ws):.1f} max "
                f"{max(ws):.1f}" for kind, ws in sorted(by.items())) + f"; {card}")
    if out["scoped"]["misses"] > out["global"]["misses"]:
        raise AssertionError(f"serving: (c) scoped misses {out['scoped']['misses']} "
                             f"above global {out['global']['misses']}")
    log(f"serving: (c) {len(trace)} results bit-identical between scoped and "
        f"global invalidation across {len(mutations)} mutations; scoped misses "
        f"{out['scoped']['misses']} <= global {out['global']['misses']}")
    return out


def phase_serving(net, median_income: int, device) -> dict:
    """The graph-serving engine, the wire and the mutating replay on the
    phase's network (SERVE_* above), with the launch counts set to 0 just
    before and read just after; the oracle's launches are not counted.
    ``intersect_rows``, ``segmented_union``, ``frontier_compact`` and
    ``csr_row_sample`` must launch, no union or frontier row may take the
    sort path, no result may be an error, and the phase must end within
    SERVE_PHASE_LIMIT_S. Returns the launch counts and the readings."""
    from repro_torch.kernels import build

    slo = serve_slo()
    t_phase = time.perf_counter()
    card = device_line()
    flt = {"attr": "income", "op": "gt", "value": median_income}
    trace = slo.build_serve_trace(net, SERVE_REQUESTS, flt, SERVE_SEED)
    mix = collections.Counter(slo.trace_kind(r) for r in trace)
    log(f"serving: trace of {len(trace)} requests (seed {SERVE_SEED}), "
        f"{json.dumps(dict(sorted(mix.items())))}; getedge on {slo.EDGE_LAYER}, "
        f"alters and khop on {' + '.join(slo.ALTER_LAYERS)}, walkbatch on "
        f"{' + '.join(slo.WALK_LAYERS)}, filter income > {median_income}")
    build.launch_counts.clear()
    engine = serving_engine(net, trace, median_income, card, device)
    counted = collections.Counter(build.launch_counts)
    serving_oracle(net, trace, engine["values"], median_income, device)
    build.launch_counts.clear()
    build.launch_counts.update(counted)
    wire = serving_wire(net, trace, engine["values"], card, device)
    mutations = serving_mutations(net, trace, card)
    sync()
    launches = dict(build.launch_counts)
    log(f"serving: launch counts {json.dumps(launches, sort_keys=True)}")
    assert_launched("serving", launches, SERVE_KERNELS)
    assert_no_sort_rows("serving", launches)
    if launches.get("frontier_sort_rows", 0):
        raise AssertionError("frontier rows took the plain path in the serving phase")
    seconds = time.perf_counter() - t_phase
    log(f"serving: phase {seconds:.3f} s (limit {SERVE_PHASE_LIMIT_S:g} s); {card}")
    if seconds > SERVE_PHASE_LIMIT_S:
        raise AssertionError(f"serving: the phase took {seconds:.1f} s, over its "
                             f"{SERVE_PHASE_LIMIT_S:g} s")
    return {"launches": launches, "engine": engine, "wire": wire,
            "mutations": mutations, "seconds": seconds}


def sharded_bench():
    """``benchmarks/torch_sharded_perf.py``: the hub-skewed graph and its
    k-hop and point queries at 1/2/4/8 shards."""
    bench = str(ROOT / "benchmarks")
    if bench not in sys.path:
        sys.path.insert(0, bench)
    import torch_sharded_perf

    return torch_sharded_perf


def same_tensor(a, b) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and bool((a == b).all())


def sharded_host_bytes(snet) -> int:
    """Bytes of the host mirrors the shards hold of their own: each sliced
    CSR's ``indptr_host`` (the member directories are shared)."""
    total = 0
    for shard in snet.shards:
        for layer in shard.layers:
            csrs = ([layer.memb] if layer.mode == 2 else [layer.out, layer.in_])
            ovs = ([layer.memb_ov] if layer.mode == 2 else [layer.out_ov, layer.in_ov])
            csrs += [ov.delta for ov in ovs if ov is not None]
            total += sum(c.indptr_host.nbytes for c in csrs if c is not None)
    return total


def sharded_build(net, card: str):
    """(a) ``shard_network`` at each of SHARD_COUNTS, one at a time, each
    freed before the next: wall, device bytes added, host-mirror bytes.
    Returns the last (SHARDS) view."""
    import torch

    from repro_torch.core.sharded import shard_network

    snet = None
    for count in SHARD_COUNTS:
        snet = None
        sync()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        snet = shard_network(net, count)
        sync()
        wall = time.perf_counter() - t0
        added = torch.cuda.max_memory_allocated() - base
        log(f"sharded: (a) shard_network at {count} shards: {wall * 1e3:.3f} ms, "
            f"device bytes added {added} (max_memory_allocated), host mirrors "
            f"{sharded_host_bytes(snet)} bytes, nbytes (views counted) "
            f"{snet.nbytes}; {card}")
    if snet.n_shards != SHARDS:
        raise AssertionError(f"sharded: the kept view has {snet.n_shards} shards")
    return snet


def sharded_queries(net, snet, median_income: int, seed: int, card: str,
                    device) -> dict:
    """(b) the main path's point queries and traversal on the sharded view
    against the unsharded network, bit for bit; each sharded call's median
    wall, device busy and idle, and launches a call. The launch counts are
    those of the sharded calls alone."""
    import torch

    from repro_torch.core import api
    from repro_torch.core.traversal import components_batched
    from repro_torch.kernels import build

    rng = np.random.default_rng(seed + 30)
    n = net.n_nodes
    sel = api.selectnodes(net, "income", ">", median_income)
    pairs = edge_pairs(net, rng, device)
    pairs["Random"] = (rng.integers(0, n, POINT_PAIRS), rng.integers(0, n, POINT_PAIRS))
    au, av = pairs["Workplaces"]
    alters_u = rng.integers(0, n, ALTERS_NODES)
    degree_u = rng.integers(0, n, DEGREE_NODES)
    khop_src = rng.integers(0, n, KHOP_SOURCES)
    khop_kw = dict(max_frontier=KHOP_MAX_FRONTIER, max_alters_per_node=KHOP_NODE_CAP)
    calls = {}
    for name, (u, v) in pairs.items():
        calls[f"getedge {name} x{POINT_PAIRS}"] = (
            lambda g, name=name, u=u, v=v: (g.edge_value(name, u, v),))
    calls[f"checkedge_any x{POINT_PAIRS}"] = lambda g: (g.check_edge_any(au, av),)
    calls[f"getnodealters x{ALTERS_NODES}, 4 layers"] = (
        lambda g: g.node_alters(alters_u, MAX_ALTERS))
    calls[f"getdegree x{DEGREE_NODES}"] = lambda g: (g.degree(degree_u),)
    calls[f"getdegree x{DEGREE_NODES} income > {median_income}"] = (
        lambda g: (g.degree(degree_u, node_filter=sel),))
    calls[f"khop all layers x{KHOP_SOURCES} k={KHOP_K} caps "
          f"{KHOP_MAX_FRONTIER}/{KHOP_NODE_CAP}"] = (
        lambda g: g.khop(khop_src, KHOP_K, **khop_kw))
    calls["countcomponents"] = lambda g: (
        g.components() if hasattr(g, "components") else components_batched(g),)

    plain = {}
    for name, call in calls.items():  # the unsharded port, not counted
        plain[name] = host_median_ms(lambda call=call: call(net), SHARDED_REPEATS)
    build.launch_counts.clear()
    outs = {}
    for name, call in calls.items():
        fn = lambda call=call: call(snet)  # noqa: E731
        before = collections.Counter(build.launch_counts)
        fn()
        sync()
        per_call = collections.Counter(build.launch_counts)
        per_call.subtract(before)
        ms, outs[name] = host_median_ms(fn, SHARDED_REPEATS)
        busy = busy_share(fn, ms, top=3)
        un_ms = plain[name][0]
        log(f"sharded: (b) {name}: {SHARDS} shards median {ms:.3f} ms vs unsharded "
            f"{un_ms:.3f} ms ({ms / un_ms:.3f}x), {busy}; launches a call "
            f"{json.dumps({k: v for k, v in sorted(per_call.items()) if v})}; {card}")
    sync()
    launches = dict(build.launch_counts)
    for name in calls:
        got, want = outs[name], plain[name][1]
        if not all(same_tensor(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"sharded: (b) {name} differs from the unsharded port")
    labels = outs["countcomponents"][0]
    log(f"sharded: (b) every result of the {len(calls)} calls equals the unsharded "
        f"port's bit for bit (dtypes too); {int(torch.unique(labels).numel())} "
        f"components; launch counts {json.dumps(launches, sort_keys=True)}")
    assert_launched("sharded (b)", launches, SHARDED_KERNELS)
    assert_no_sort_rows("sharded (b)", launches)
    if launches.get("frontier_sort_rows", 0):
        raise AssertionError("sharded: (b) frontier rows took the plain path")
    return launches


class PlainDraws:
    """Within the block, ``ops.randint`` runs its plain torch version (on
    the card's tensors)."""

    def __enter__(self):
        from repro_torch.kernels import ops, ref

        self._real = ops.randint
        ops.randint = ref.randint_ref
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import ops

        ops.randint = self._real


def sharded_two_mode(net, seed: int, card: str, device) -> dict:
    """(c) ``ShardedTwoMode`` on SHARDED_WALK_LAYER at SHARDS shards: the
    loop version of the shard_map edge value against the unsharded layer,
    and the walk step against itself with the plain draws, exactly; every
    move lands on a co-member. Launch counts of the kernel runs alone."""
    import torch

    from repro_torch.core.sharded import (
        make_sharded_edge_value, make_sharded_walk_step, shard_two_mode,
    )
    from repro_torch.kernels import build

    layer = net.layer(SHARDED_WALK_LAYER)
    rng = np.random.default_rng(seed + 31)
    t0 = time.perf_counter()
    graph = shard_two_mode(layer, SHARDS)
    sync()
    build_ms = (time.perf_counter() - t0) * 1e3
    u, v = pair_ids(layer, net.n_nodes, POINT_PAIRS, rng, device)
    starts = torch.from_numpy(
        rng.integers(0, net.n_nodes, SHARDED_WALKERS).astype(np.int32)).to(device)
    want_edge = net.edge_value(SHARDED_WALK_LAYER, u, v)
    edge_value = make_sharded_edge_value(graph)
    step = make_sharded_walk_step(graph)

    def walk():
        w, path = starts, [starts]
        for t in range(SHARDED_WALK_STEPS):
            w = step(w, t)
            path.append(w)
        return torch.stack(path)

    with PlainDraws():
        want_walk = walk()
    sync()
    build.launch_counts.clear()
    edge_ms, got_edge = host_median_ms(lambda: edge_value(u, v), SHARDED_REPEATS)
    walk_ms, got_walk = host_median_ms(walk, SHARDED_REPEATS)
    launches = dict(build.launch_counts)
    if not same_tensor(got_edge, want_edge):
        raise AssertionError("sharded: (c) make_sharded_edge_value differs from the "
                             "unsharded edge value")
    if not same_tensor(got_walk, want_walk):
        raise AssertionError("sharded: (c) the walk step's kernels differ from its "
                             "plain draws")
    moved = got_walk[1:] != got_walk[:-1]
    hops = net.edge_value(SHARDED_WALK_LAYER, got_walk[:-1].reshape(-1),
                          got_walk[1:].reshape(-1)).reshape(moved.shape)
    if bool((moved & (hops == 0)).any()):
        raise AssertionError("sharded: (c) a walker moved to a node it shares no "
                             "group with")
    log(f"sharded: (c) ShardedTwoMode on {SHARDED_WALK_LAYER} at {SHARDS} shards "
        f"({graph.rows_per_shard} rows a shard, built in {build_ms:.3f} ms): edge "
        f"value x{POINT_PAIRS} median {edge_ms:.3f} ms, equal to the unsharded "
        f"layer's ({int((got_edge > 0).sum())} pairs share a group); walk step "
        f"{SHARDED_WALKERS} walkers x {SHARDED_WALK_STEPS} steps median "
        f"{walk_ms:.3f} ms, equal to the plain draws', {int(moved.sum())} moves, "
        f"each to a co-member; launches {json.dumps(launches, sort_keys=True)}; {card}")
    assert_launched("sharded (c)", launches, ("intersect_count", "randint"))
    return launches


def sharded_engine(net, median_income: int, card: str, device) -> dict:
    """(d) ``GraphServeEngine(net, shards=SHARDS)`` on the serving trace:
    every record equal to the unsharded engine's, requests/s of both, a
    profiled run with the pump started (every launch and copy under the
    pump's ids), then one add_edges through the pump, which must take the
    ``reshard_deltas`` route, and a getedge of the new ties."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import sharded
    from repro_torch.kernels import build
    from repro_torch.serve import GraphServeEngine

    slo = serve_slo()
    flt = {"attr": "income", "op": "gt", "value": median_income}
    trace = slo.build_serve_trace(net, SERVE_REQUESTS, flt, SERVE_SEED)
    n = len(trace)
    t0 = time.perf_counter()
    want = [r.to_record() for r in GraphServeEngine(
        net, cache_size=SERVE_CACHE).serve(trace)]
    sync()
    plain_qps = n / (time.perf_counter() - t0)
    t0 = time.perf_counter()
    engine = GraphServeEngine(net, cache_size=SERVE_CACHE, shards=SHARDS)
    sync()
    view_ms = (time.perf_counter() - t0) * 1e3
    build.launch_counts.clear()
    t0 = time.perf_counter()
    got = [r.to_record() for r in engine.serve(trace)]
    sync()
    qps = n / (time.perf_counter() - t0)
    wrong = [i for i, (a, b) in enumerate(zip(got, want)) if a != b]
    if wrong or len(got) != n:
        raise AssertionError(f"sharded: (d) {len(wrong)} records differ from the "
                             f"unsharded engine's, first at request {wrong[:1]}")
    log(f"sharded: (d) GraphServeEngine(shards={SHARDS}) on the serving trace "
        f"({n} requests, seed {SERVE_SEED}): {qps:.1f} requests/s vs unsharded "
        f"{plain_qps:.1f} ({qps / plain_qps:.3f}x); every record equal; the view "
        f"built in {view_ms:.3f} ms; launches "
        f"{json.dumps(dict(sorted(build.launch_counts.items())))}; {card}")

    engine = GraphServeEngine(net, cache_size=SERVE_CACHE, shards=SHARDS).start()
    pump = engine.pump_thread
    routes = []
    real = sharded.reshard_deltas

    def spy(snet, new_net):
        view = real(snet, new_net)
        routes.append(view is not None)
        return view

    try:
        with ServeThreads() as watch:
            before = collections.Counter(build.launch_counts)
            with warnings.catch_warnings():
                warnings.filterwarnings("ignore", message=".*Profiler clears events")
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    t0 = time.perf_counter()
                    served = engine.serve(trace)
                    sync()
                    wall = (time.perf_counter() - t0) * 1e3
            launched = graph_launches(build.launch_counts - before)
            rng = np.random.default_rng(SERVE_MUTATION_SEED + 1)
            src = rng.integers(0, net.n_nodes, SHARDED_MUTATION_TIES)
            dst = rng.integers(0, net.n_nodes, SHARDED_MUTATION_TIES)
            sharded.reshard_deltas = spy
            try:
                t0 = time.perf_counter()
                engine.add_edges("Random", src, dst)
                add_ms = (time.perf_counter() - t0) * 1e3
            finally:
                sharded.reshard_deltas = real
            after = engine.serve([{"kind": "getedge", "layer": "Random",
                                   "u": int(a), "v": int(b)} for a, b in zip(src, dst)])
        view = engine._sharded
        served_net = engine.net
    finally:
        engine.close()
    # with the pump started, rounds cut the trace elsewhere, so which
    # requests read the cache differs; the results may not
    uncached = [{k: v for k, v in rec.items() if k != "cached"} for rec in want]
    if [{k: v for k, v in r.to_record().items() if k != "cached"}
            for r in served] != uncached:
        raise AssertionError("sharded: (d) the started engine's results differ")
    acts = device_events(prof)
    delivered = graph_kernel_events(acts)
    tids = launch_threads(prof)
    if set(tids) - thread_ids(pump) or not tids:
        raise AssertionError(f"sharded: (d) CUDA launches or copies off the pump "
                             f"thread (ids {sorted(thread_ids(pump))}): {dict(tids)}")
    off_pump = {t: k for t, k in watch.threads.items() if t != pump.ident}
    if off_pump or set(watch.mutations) != {pump.ident}:
        raise AssertionError(f"sharded: (d) executors or the mutation off the pump: "
                             f"{off_pump}, {dict(watch.mutations)}")
    if routes != [True]:
        raise AssertionError(f"sharded: (d) the add_edges re-shard took routes "
                             f"{routes}, not reshard_deltas")
    if view.source is not served_net or [r.value for r in after] != [1.0] * len(src):
        raise AssertionError("sharded: (d) the view after add_edges is stale")
    if delivered >= launched:
        device_text = busy_line(acts, wall, top=4)
    else:
        device_text = (f"device busy not measured (the window lost events: "
                       f"{delivered} graph-kernel events for {launched} launches)")
    log(f"sharded: (d) started engine, profiled: wall {wall:.3f} ms, {device_text}; "
        f"{sum(tids.values())} launches and copies, all under the pump's ids; "
        f"add_edges of {len(src)} Random ties through the pump {add_ms:.3f} ms "
        f"(reshard_deltas), getedge after it reads 1.0 for each; {card}")
    return dict(build.launch_counts)


def phase_sharded(net, median_income: int, seed: int, device) -> dict:
    """The sharded network view (``core/sharded.py``) on the phase's
    network: (a) shard building, (b) the main path's queries and traversal
    at SHARDS shards against the unsharded port, (c) the ShardedTwoMode
    loop, (d) the engine with ``shards=SHARDS``, (e) the sharded benchmark
    at its default; counts reset before and read after each part. Returns
    the launches of the sharded calls, summed over the parts."""
    import torch

    from repro_torch.kernels import build

    t_phase = time.perf_counter()
    card = device_line()
    snet = sharded_build(net, card)
    total = collections.Counter()
    total.update(sharded_queries(net, snet, median_income, seed, card, device))
    del snet
    total.update(sharded_two_mode(net, seed, card, device))
    build.launch_counts.clear()
    total.update(sharded_engine(net, median_income, card, device))
    torch.cuda.empty_cache()
    build.launch_counts.clear()
    t0 = time.perf_counter()
    out = sharded_bench().measure(SHARDED_BENCH_NODES, SHARDED_BENCH_HUB, False,
                                  device, log=lambda m: log(f"sharded: (e) {m}"))
    sync()
    bench = dict(build.launch_counts)
    total.update(bench)
    log(f"sharded: (e) benchmarks/torch_sharded_perf.py in "
        f"{time.perf_counter() - t0:.3f} s: khop ms " + ", ".join(
            f"{s} shard(s) {out[f'sharded/khop_{s}shard_ms']:.3f}" for s in (1, 2, 4, 8))
        + f"; 1-over-4 {out['sharded/khop_4shard_speedup_x']:.3f}x; candidate "
        "entries " + ", ".join(
            f"{s}: {out[f'sharded/khop_{s}shard_candidates']}" for s in (1, 2, 4, 8))
        + f"; launches {json.dumps(bench, sort_keys=True)}; {card}")
    assert_launched("sharded (e)", bench, ("frontier_compact",))
    assert_no_sort_rows("sharded", total)
    seconds = time.perf_counter() - t_phase
    log(f"sharded: launch counts of the phase {json.dumps(dict(sorted(total.items())))}"
        f"; phase {seconds:.3f} s (limit {SHARDED_PHASE_LIMIT_S:g} s); {card}")
    assert_launched("sharded", total, SHARDED_KERNELS)
    if seconds > SHARDED_PHASE_LIMIT_S:
        raise AssertionError(f"sharded: the phase took {seconds:.1f} s, over its "
                             f"{SHARDED_PHASE_LIMIT_S:g} s")
    return {"launches": dict(total), "bench": out, "seconds": seconds}



class KernelInputs:
    """Within the block, keeps a copy of the inputs of the first launch of
    every distinct shape of each LM kernel, under ``label``, so the checks
    and the timing phase run each kernel on the data the lm phase gave it.
    Wraps ``ops.<kernel>_cuda``; it counts nothing in ``launch_counts``."""

    NAMES = ("flash_attention", "rmsnorm", "ssd_scan", "rglru_scan")

    def __init__(self, label: str, names: tuple | None = None):
        self.label = label
        self.names = self.NAMES if names is None else names
        self.seen = {}  # (kernel, label, shapes) -> (args, kwargs)
        self.calls = collections.Counter()  # (kernel, label, shapes) -> calls

    def __enter__(self):
        import torch

        from repro_torch.kernels import ops

        self._inner = {n: getattr(ops, f"{n}_cuda") for n in self.names}

        def recorder(name, inner):
            def record(*args, **kwargs):
                key = (name, self.label, tuple(
                    (tuple(a.shape), str(a.dtype)) for a in args
                    if isinstance(a, torch.Tensor)))
                self.calls[key] += 1
                if key not in self.seen:
                    self.seen[key] = (
                        [a.clone() if isinstance(a, torch.Tensor) else a
                         for a in args], dict(kwargs))
                return inner(*args, **kwargs)
            return record

        for n, inner in self._inner.items():
            setattr(ops, f"{n}_cuda", recorder(n, inner))
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import ops

        for n, inner in self._inner.items():
            setattr(ops, f"{n}_cuda", inner)


def lm_plain(name: str):
    """The plain torch version of an LM kernel's CUDA wrapper, same
    arguments."""
    from repro_torch.kernels import ref

    return {
        "flash_attention": ref.attention_heads_ref,
        "rmsnorm": ref.rmsnorm_ref,
        "ssd_scan": ref.ssd_scan_heads_ref,
        "rglru_scan": ref.rglru_scan_ref,
    }[name]


def lm_kernel(name: str):
    from repro_torch.kernels import ops

    return getattr(ops, f"{name}_cuda")


def lm_excess(got, want, rel: float = LM_REL_TOL, floor: float = LM_FLOOR_TOL
              ) -> tuple[float, float]:
    """(max |got - want|, largest ratio of |got - want| to its limit
    rel |want| + floor max |want|); NaN in ``got`` gives NaN."""
    import torch

    diff = (got - want).abs()
    limit = (rel * want.abs() + floor * float(want.abs().max())
             ).clamp_min(torch.finfo(torch.float32).tiny)
    return float(diff.max()), float((diff / limit).max())


def round_bits(t, bits: int):
    """``t`` rounded to ``bits`` significant bits (a planted fault)."""
    import torch

    m, e = torch.frexp(t)
    return torch.ldexp(torch.round(m * 2.0**bits) / 2.0**bits, e)


def lm_kernel_checks(seen: dict, phase: str = "lm") -> dict:
    """Each LM kernel against its plain version, evaluated in f32 on the
    same inputs, at every shape the lm phase launched it at -> {kernel: max
    abs error}. Every element must lie within its limit (``lm_excess``
    ratio <= 1), and the same check must reject two planted faults."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    worst, bad = {}, []
    for (name, label, shapes), (args, kwargs) in seen.items():
        got = lm_kernel(name)(*args, **kwargs).float()
        want = lm_plain(name)(*[a.float() if isinstance(a, torch.Tensor) else a
                                for a in args], **kwargs)
        err, ratio = lm_excess(got, want) if got.numel() else (0.0, 0.0)
        worst[name] = max(worst.get(name, 0.0), err)
        _, zero_ratio = lm_excess(torch.zeros_like(want), want)
        _, coarse_ratio = lm_excess(round_bits(want, LM_FAULT_BITS), want)
        ok = bool(torch.isfinite(got).all()) and ratio <= 1.0
        caught = zero_ratio > 1.0 and coarse_ratio > 1.0
        rel = float((got - want).norm() / want.norm().clamp_min(1e-30))
        log(f"{phase}: {label} {name} at {[list(sh) for sh, _ in shapes]} "
            f"{shapes[0][1]} against its plain version in f32: max_abs_err "
            f"{err:.3e} (reference max |y| {float(want.abs().max()):.3e}, "
            f"norm-relative error {rel:.3e}); worst ratio to the limit "
            f"{ratio:.3f} ({'ok' if ok else 'FAILS'}; limit {LM_REL_TOL:g} |y| + "
            f"{LM_FLOOR_TOL:g} max |y|); planted faults: zeroed output "
            f"{zero_ratio:.3g}, reference rounded to {LM_FAULT_BITS} bits "
            f"{coarse_ratio:.3g} ({'both rejected' if caught else 'NOT REJECTED'})")
        if not ok or not caught:
            bad.append(f"{label}/{name}{[list(sh) for sh, _ in shapes]}")
        del got, want
    if bad:
        raise AssertionError(
            f"LM kernel checks failed (disagreement, or a planted fault not "
            f"rejected): {bad}")
    return worst


def bf16_ulp(x: float) -> float:
    return 2.0 ** (math.floor(math.log2(max(abs(x), 1e-30))) - 7)


def lm_phases(model, engine, prompts, reqs, device, prefills: int = 3) -> tuple:
    """The phases of one generate call with a sync around each: median
    prefill ms of ``prefills`` calls, median ms per decode step (sampling
    included), and the caches, tokens and position of the last step."""
    import torch

    tokens = torch.from_numpy(prompts).to(device)
    B, P = prompts.shape[:2]
    pre = []
    for _ in range(prefills):
        sync()
        t0 = time.perf_counter()
        logits, caches = model.prefill(tokens, LM_MAX_SEQ)
        sync()
        pre.append((time.perf_counter() - t0) * 1e3)
    cur = engine._sample(logits[:, 0], reqs)
    steps = []
    for t in range(1, LM_NEW):
        pos = torch.full((B,), P + t - 1, dtype=torch.int32, device=device)
        sync()
        t0 = time.perf_counter()
        logits, caches = model.decode_step(cur[:, None], caches, pos)
        cur = engine._sample(logits[:, 0], reqs)
        sync()
        steps.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(pre), statistics.median(steps), caches, cur, pos


def lm_kernels(cfg) -> tuple[set, set]:
    """(kernels the configuration's serving path must launch, kernels it
    must not): rmsnorm always; flash_attention where an attention layer is
    neither windowed nor soft-capped (such layers take the plain blocked
    attention, as the reference sends them past its Pallas kernel), else
    never; ssd_scan for Mamba2 layers, rglru_scan for RG-LRU layers."""
    kinds = set(cfg.block_pattern)
    flash = ("attn" in kinds and cfg.attn_window is None
             and cfg.attn_logit_softcap is None)
    must = {"rmsnorm"} | ({"flash_attention"} if flash else set())
    must |= {"ssd_scan"} if "mamba" in kinds else set()
    must |= {"rglru_scan"} if "rglru" in kinds else set()
    return must, set() if flash else {"flash_attention"}


def lm_serve(arch: str, cfg, device, seed: int, *, phase: str = "lm",
             repeats: int = LM_REPEATS, prefills: int = 3,
             phase_kinds: tuple | None = None) -> dict:
    """One configuration in bf16 through ``ServeEngine.generate`` (one
    warm-up and ``repeats`` timed calls a kind), with the launch counts set
    to 0 just before and read just after; then its timing (prefill and
    decode step timed apart for each call kind, or for ``phase_kinds``),
    profile and checks. Audio models take prompts of their codebooks; a MoE model's
    routing and a VLM's prefix get lines of their own."""
    import torch

    from repro_torch.kernels import build
    from repro_torch.models.config import param_count
    from repro_torch.models.lm_serve import Request, ServeEngine
    from repro_torch.models.model import Model

    t0 = time.perf_counter()
    model = Model(cfg, device=device).init(
        torch.Generator(device=device).manual_seed(seed))
    sync()
    n_params = param_count(cfg)
    log(f"{phase}: {arch}: {n_params} parameters in {cfg.dtype}, {cfg.n_layers} "
        f"layers, d_model {cfg.d_model}, vocab {cfg.vocab_size}; drawn on the "
        f"card in {time.perf_counter() - t0:.3f} s")
    rng = np.random.default_rng(seed + 20)
    K = cfg.n_codebooks
    prompts = rng.integers(2, cfg.vocab_size,
                           (LM_REQUESTS, LM_PROMPT) + ((K,) if K else ()))
    calls = {
        "greedy": [Request(prompt=p, max_new_tokens=LM_NEW, rid=i)
                   for i, p in enumerate(prompts)],
        f"temperature {LM_TEMPERATURE}": [
            Request(prompt=p, max_new_tokens=LM_NEW, temperature=LM_TEMPERATURE,
                    rid=i) for i, p in enumerate(prompts)],
    }
    engine = ServeEngine(model, max_seq=LM_MAX_SEQ, seed=seed)
    n_tokens = LM_REQUESTS * LM_NEW

    torch.cuda.reset_peak_memory_stats()
    build.launch_counts.clear()
    outputs, walls = collections.defaultdict(list), {}

    def generate(label, reqs):
        out = engine.generate(reqs)
        outputs[label].append(np.stack([c.tokens for c in out]))
        return out

    with KernelInputs(arch) as rec:
        for label, reqs in calls.items():
            walls[label], _ = host_median_ms(lambda: generate(label, reqs), repeats)
    sync()
    launches = dict(build.launch_counts)
    runs = len(calls) * (repeats + 1)
    log(f"{phase}: {arch}: launch counts {json.dumps(launches, sort_keys=True)} over "
        f"{runs} generate calls ({ {k: v / runs for k, v in launches.items()} } "
        f"per call); max_memory_allocated {torch.cuda.max_memory_allocated()}")
    must, never = lm_kernels(cfg)
    for k in sorted(must):
        if launches.get(k, 0) == 0:
            raise AssertionError(f"kernel {k} never launched on the {arch} path")
    for k in sorted(never):
        if launches.get(k, 0):
            raise AssertionError(f"{k} launched {launches[k]} times on the {arch} "
                                 "path, whose attention is windowed or soft-capped")
    n_rglru = sum(layer.kind == "rglru" for layer in model.layers)
    if n_rglru and launches.get("rglru_scan", 0) != n_rglru * runs:
        raise AssertionError(
            f"{arch}: rglru_scan launched {launches.get('rglru_scan', 0)} times in "
            f"{runs} generate calls, want {n_rglru} a prefill and none in decode")
    # the bf16 path reads the layer's q, k, v on the tensor cores, uncopied,
    # and runs its SSD scan on the tensor cores
    if cfg.family == "ssm":
        log(f"{phase}: {arch}: SSD routes: ssd_scan (tensor cores) "
            f"{launches.get('ssd_scan', 0)}, ssd_scan_fma (CUDA cores) "
            f"{launches.get('ssd_scan_fma', 0)}")
    for k in ("flash_attention_copies", "flash_attention_fma", "ssd_scan_fma"):
        if launches.get(k, 0):
            raise AssertionError(f"{k} is {launches[k]} on the {arch} path, not 0")

    weight_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    for label, reqs in calls.items():
        if phase_kinds is not None and label not in phase_kinds:
            log(f"{phase}: {arch} {label} x{LM_REQUESTS}, prompt {LM_PROMPT}, "
                f"{LM_NEW} new: median {walls[label]:.3f} ms per generate call, "
                f"{n_tokens / walls[label] * 1e3:.1f} tokens/s; {device_line()}")
            continue
        pre_ms, step_ms, caches, cur, pos = lm_phases(model, engine, prompts, reqs,
                                                     device, prefills)
        log(f"{phase}: {arch} {label} x{LM_REQUESTS}, prompt {LM_PROMPT}, {LM_NEW} new: "
            f"median {walls[label]:.3f} ms per generate call, "
            f"{n_tokens / walls[label] * 1e3:.1f} tokens/s; prefill {pre_ms:.3f} ms, "
            f"decode {step_ms:.3f} ms per step (weights {weight_bytes} bytes: "
            f">= {weight_bytes / HBM_BYTES_PER_S * 1e3:.3f} ms a step); "
            f"{device_line()}")
    tokens = torch.from_numpy(prompts).to(device)
    log(f"{phase}: {arch} prefill: " + busy_share(
        lambda: model.prefill(tokens, LM_MAX_SEQ), pre_ms, top=4))
    log(f"{phase}: {arch} decode step: " + busy_share(
        lambda: model.decode_step(cur[:, None], caches, pos), step_ms, top=4))
    if cfg.n_experts:
        moe_routing(arch, model, tokens, cur, caches, pos, phase)
    del caches

    # checks: tokens in range, greedy deterministic (every greedy call,
    # warm-up included, served the same tokens) and equal to the argmax of
    # the full forward, temperature draws not all greedy
    greedy = outputs["greedy"][-1]
    hot = outputs[f"temperature {LM_TEMPERATURE}"][-1]
    shape = (LM_REQUESTS, LM_NEW) + ((K,) if K else ())
    for name, toks in (("greedy", greedy), ("temperature", hot)):
        if toks.shape != shape or toks.min() < 0 or toks.max() >= cfg.vocab_size:
            raise AssertionError(f"{arch} {name} tokens out of range: {toks.shape}")
    if not all(np.array_equal(again, greedy) for again in outputs["greedy"]):
        raise AssertionError(f"{arch}: greedy generate is not deterministic")
    # audio: one choice a codebook
    with torch.no_grad():  # evaluation only
        last = model.apply(tokens)[0][:, -1].float().reshape(-1, cfg.vocab_size)
    if not bool(torch.isfinite(last).all()):
        raise AssertionError(f"{arch}: non-finite logits from Model.apply")
    # the chance that correct draws at the temperature all take the greedy
    # first tokens: a model whose logits peak far above the rest (tied
    # embeddings scaled by sqrt(d_model) echo the input token) may draw the
    # greedy tokens throughout, and then equal tokens prove nothing
    p_same = float(torch.softmax(last / LM_TEMPERATURE, dim=-1).amax(dim=-1).prod())
    if np.array_equal(hot, greedy) and p_same < 1e-6:
        raise AssertionError(f"{arch}: temperature sampling returned the greedy tokens")
    want = last.argmax(dim=-1).cpu().numpy()
    first = greedy[:, 0].reshape(-1)
    ties = 0
    for i in np.nonzero(want != first)[0]:
        top, got = float(last[i, want[i]]), float(last[i, first[i]])
        if top - got > bf16_ulp(top):
            raise AssertionError(
                f"{arch}: choice {i} served token {first[i]} (logit {got}) "
                f"where Model.apply's argmax is {want[i]} (logit {top})")
        ties += 1
    log(f"{phase}: {arch}: greedy tokens deterministic over "
        f"{len(outputs['greedy'])} calls; first tokens equal the argmax "
        f"of Model.apply for {want.size - ties} of {want.size} "
        f"{'codebook choices' if K else 'requests'} "
        f"({ties} within one bf16 ulp of a tie); temperature {LM_TEMPERATURE} "
        f"differs from greedy in {int((hot != greedy).sum())} of {hot.size} tokens "
        f"(chance that correct draws take every greedy first token {p_same:.3g})")
    del last
    if cfg.n_prefix_embeds:
        vlm_prefix_run(arch, model, tokens, seed, phase)
    del model, engine
    torch.cuda.empty_cache()
    return {"launches": launches, "seen": rec.seen}


def moe_routing(arch: str, model, tokens, cur, caches, pos, phase: str) -> None:
    """Tokens a routed expert takes, summed over the MoE layers, and the
    share dropped past the capacity, at one prefill and one decode step
    (8 decode tokens over 16 experts: capacity 1, so the reference drops
    too)."""
    import torch

    from repro_torch.models.layers import MoE

    moes = [layer.ffn for layer in model.layers if isinstance(layer.ffn, MoE)]
    for label, call in (
        ("prefill", lambda: model.prefill(tokens, LM_MAX_SEQ)),
        ("decode step", lambda: model.decode_step(cur[:, None], caches, pos)),
    ):
        stats = []
        for m in moes:
            m.route_stats = stats
        call()
        for m in moes:
            m.route_stats = None
        per_expert = torch.stack([c for c, _ in stats]).sum(dim=0).cpu().tolist()
        dropped = int(sum(int(d) for _, d in stats))
        routed = int(sum(per_expert))
        log(f"{phase}: {arch} MoE routing at {label} over {len(moes)} layers: tokens "
            f"per expert {per_expert}; dropped past the capacity {dropped} of "
            f"{routed} ({dropped / max(routed, 1):.4f})")


def vlm_prefix_run(arch: str, model, tokens, seed: int, phase: str) -> None:
    """One ``Model.prefill`` with ``n_prefix_embeds`` seeded patch
    embeddings ahead of the prompt, then LM_FAMILY_PREFIX_STEPS greedy
    decode steps at positions offset by the prefix."""
    import torch

    cfg = model.cfg
    n_pre = cfg.n_prefix_embeds
    gen = torch.Generator(device=model.device).manual_seed(seed + 22)
    prefix = torch.randn((tokens.shape[0], n_pre, cfg.d_model), generator=gen,
                         device=model.device).to(model.embed.dtype)
    max_seq = n_pre + LM_PROMPT + LM_FAMILY_PREFIX_STEPS
    sync()
    t0 = time.perf_counter()
    logits, caches = model.prefill(tokens, max_seq, prefix)
    sync()
    pre_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    for t in range(LM_FAMILY_PREFIX_STEPS):
        cur = logits[:, 0].argmax(dim=-1).to(torch.int32)
        pos = torch.full((tokens.shape[0],), n_pre + LM_PROMPT + t, dtype=torch.int32,
                         device=model.device)
        logits, caches = model.decode_step(cur[:, None], caches, pos)
    sync()
    step_ms = (time.perf_counter() - t0) * 1e3 / LM_FAMILY_PREFIX_STEPS
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{arch}: non-finite logits after the prefix run")
    log(f"{phase}: {arch} with {n_pre} patch embeddings ahead of {LM_PROMPT} tokens "
        f"x{tokens.shape[0]}: prefill {pre_ms:.3f} ms, {LM_FAMILY_PREFIX_STEPS} decode "
        f"steps at positions {n_pre + LM_PROMPT}.. {step_ms:.3f} ms per step; "
        f"logits finite")
    del caches, logits


def lm_decode_check(arch: str, cfg, device, seed: int, *, phase: str = "lm",
                    n_layers: int | None = None) -> float:
    """An f32 copy of the configuration at full width (``n_layers`` deep
    where given: the cut is printed): prefill of LM_CHECK_PROMPT tokens
    (after n_prefix_embeds seeded patch embeddings for a VLM, the decode
    positions offset by them) and LM_CHECK_STEPS teacher-forced decode
    steps against ``Model.apply`` at the same positions -> max |Δ logit|.
    MoE layers run at capacity factor n_experts, so no token is dropped and
    prefill, decode and the full forward route alike."""
    import dataclasses

    import torch

    from repro_torch.models.model import Model

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cut = {}
    if n_layers is not None and n_layers != cfg.n_layers:
        cut["n_layers"] = n_layers
    if cfg.n_experts:
        cut["moe_capacity_factor"] = float(cfg.n_experts)
    cfg32 = dataclasses.replace(cfg, dtype="float32", **cut)
    model = Model(cfg32, device=device).init(
        torch.Generator(device=device).manual_seed(seed))
    P, n, K = LM_CHECK_PROMPT, LM_CHECK_STEPS, cfg.n_codebooks
    tokens = torch.from_numpy(np.random.default_rng(seed + 21).integers(
        2, cfg.vocab_size, (LM_CHECK_REQUESTS, P + n) + ((K,) if K else ()))).to(device)
    n_pre = cfg.n_prefix_embeds
    prefix = None
    if n_pre:
        gen = torch.Generator(device=device).manual_seed(seed + 23)
        prefix = torch.randn((LM_CHECK_REQUESTS, n_pre, cfg.d_model), generator=gen,
                             device=device)
    with torch.no_grad():  # evaluation only
        full = model.apply(tokens, prefix)[0][:, n_pre:]
    last, caches = model.prefill(tokens[:, :P], n_pre + P + n, prefix)
    errs = [float((last[:, 0] - full[:, P - 1]).abs().max())]
    for t in range(P, P + n):
        pos = torch.full((LM_CHECK_REQUESTS,), n_pre + t, dtype=torch.int32,
                         device=device)
        logits, caches = model.decode_step(tokens[:, t:t + 1], caches, pos)
        errs.append(float((logits[:, 0] - full[:, t]).abs().max()))
    err = max(errs)
    finite = bool(torch.isfinite(full).all())
    what = "".join(f"; {k}={v}" for k, v in cut.items())
    if n_pre:
        what += f"; {n_pre} patch embeddings ahead, positions offset by them"
    log(f"{phase}: {arch} f32 (TF32 off{what}): prefill {P} + {n} decode steps "
        f"against Model.apply, {LM_CHECK_REQUESTS} requests: max |dlogit| {err:.3e} "
        f"(per step {', '.join(f'{e:.2e}' for e in errs)}; logits std "
        f"{float(full.std()):.3f}; atol {LM_F32_ATOL:g})")
    del model, full, caches
    torch.cuda.empty_cache()
    if not finite or err > LM_F32_ATOL:
        raise AssertionError(f"{arch}: f32 decode differs from the full forward by {err}")
    return err


def phase_lm(device, seed: int, configs: dict | None = None) -> dict:
    """LM serving at full width for each of LM_ARCHS (``configs`` maps an
    arch to its config; the default is the published one), then the kernel
    checks at the recorded shapes. Returns the launch counts summed over
    the configurations, each kernel's worst error and the recorded inputs."""
    from repro_torch.configs import get_config

    t0 = time.perf_counter()
    configs = configs or {arch: get_config(arch) for arch in LM_ARCHS}
    launches, seen = collections.Counter(), {}
    for arch, cfg in configs.items():
        out = lm_serve(arch, cfg, device, seed)
        launches.update(out["launches"])
        seen.update(out["seen"])
        lm_decode_check(arch, cfg, device, seed)
    worst = lm_kernel_checks(seen)
    log(f"lm: launch counts over both configurations "
        f"{json.dumps(dict(launches), sort_keys=True)}; worst kernel errors "
        f"{json.dumps(worst, sort_keys=True)}; phase took "
        f"{time.perf_counter() - t0:.3f} s")
    return {"launches": dict(launches), "worst": worst, "seen": seen}


def family_configs() -> dict:
    """LM_FAMILY_ARCHS' published configurations, each cut to its
    LM_FAMILY_LAYERS depth where it has one (the cut printed)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models.config import param_count

    configs = {}
    for arch in LM_FAMILY_ARCHS:
        cfg = get_config(arch)
        depth = LM_FAMILY_LAYERS.get(arch)
        if depth is not None and depth != cfg.n_layers:
            cut = dataclasses.replace(cfg, n_layers=depth)
            full_bytes = 2 * param_count(cfg)
            why = (f"all {cfg.n_layers} take {full_bytes} bytes in bf16, past the "
                   f"card's memory" if full_bytes > LM_CARD_BYTES else LM_FAMILY_TIME_CUT)
            log(f"lm_families: {arch}: depth cut to {depth} of {cfg.n_layers} layers "
                f"({why}; {depth} take {2 * param_count(cut)} bytes); widths, "
                f"experts and vocabulary as published")
            cfg = cut
        configs[arch] = cfg
    return configs


def rmsnorm_routes(seen: dict) -> None:
    """Prints which rmsnorm kernel each width launched (a profiled call of
    the kernel on the recorded inputs): the register route
    ``rmsnorm_kernel`` or the two-pass ``rmsnorm_any_kernel``."""
    for (name, label, shapes), (args, kwargs) in seen.items():
        if name != "rmsnorm":
            continue
        try:
            acts = device_activity(lambda: lm_kernel(name)(*args, **kwargs), 20)
            route = ", ".join(sorted(k for k in acts if "rmsnorm" in k)) or "none seen"
        except ProfilerLostEvents:
            route = "not measured (the profiler lost the window)"
        log(f"lm_families: {label} rmsnorm at {list(shapes[0][0])} {shapes[0][1]}: "
            f"route {route}")


def seeded_state_inputs(seen: dict, seed: int) -> dict:
    """For each recorded rglru_scan launch, the same a and b with a seeded
    nonzero h0: every prefill on the main path starts from a zero state, so
    a kernel that ignored h0 would pass there."""
    import torch

    out = {}
    for (name, label, shapes), (args, kwargs) in seen.items():
        if name != "rglru_scan":
            continue
        a, b = args[:2]
        gen = torch.Generator(device=a.device).manual_seed(seed + 24)
        h0 = torch.randn((a.shape[0], a.shape[2]), generator=gen, device=a.device)
        out[(name, f"{label} (h0 seeded)", shapes[:2] + (
            (tuple(h0.shape), str(h0.dtype)),))] = ([a, b, h0], dict(kwargs))
    return out


def phase_lm_families(device, seed: int, configs: dict | None = None) -> dict:
    """LM serving at full width for each of LM_FAMILY_ARCHS (``configs`` maps
    an arch to its config; the default is ``family_configs()``): MoE,
    the RG-LRU hybrid with windowed attention, the VLM prefix and the audio
    codebooks, each freed before the next is built; then the kernel checks
    at the recorded shapes, rglru_scan among them (also from a seeded
    nonzero state: ``seeded_state_inputs``). Fails past
    LM_FAMILY_PHASE_LIMIT_S. Returns the launch counts summed over the
    configurations, each kernel's worst error and the recorded inputs."""
    t0 = time.perf_counter()
    configs = configs or family_configs()
    launches, seen = collections.Counter(), {}
    for arch, cfg in configs.items():
        t_arch = time.perf_counter()
        out = lm_serve(arch, cfg, device, seed, phase="lm_families",
                       repeats=LM_FAMILY_REPEATS, prefills=LM_FAMILY_PREFILLS,
                       phase_kinds=("greedy",))
        launches.update(out["launches"])
        seen.update(out["seen"])
        lm_decode_check(arch, cfg, device, seed, phase="lm_families",
                        n_layers=LM_FAMILY_CHECK_LAYERS.get(
                            arch, LM_FAMILY_CHECK_DEFAULT_LAYERS))
        log(f"lm_families: {arch} took {time.perf_counter() - t_arch:.3f} s")
    worst = lm_kernel_checks({**seen, **seeded_state_inputs(seen, seed)},
                             phase="lm_families")
    rmsnorm_routes(seen)
    seconds = time.perf_counter() - t0
    log(f"lm_families: launch counts over the {len(configs)} configurations "
        f"{json.dumps(dict(launches), sort_keys=True)}; worst kernel errors "
        f"{json.dumps(worst, sort_keys=True)}; phase {seconds:.3f} s (limit "
        f"{LM_FAMILY_PHASE_LIMIT_S:g} s); {device_line()}")
    if seconds > LM_FAMILY_PHASE_LIMIT_S:
        raise AssertionError(f"lm_families: the phase took {seconds:.1f} s, over its "
                             f"{LM_FAMILY_PHASE_LIMIT_S:g} s")
    return {"launches": dict(launches), "worst": worst, "seen": seen,
            "seconds": seconds}


def rglru_timing(families: dict) -> dict:
    """The rglru_scan record at the heaviest shape the lm_families phase
    launched it at: the kernel cold (CUDA events, the L2 flushed before
    each launch: a prefill's a and b are written just before, but 805 MB
    at recurrentgemma's width pass through the 50 MB L2), the plain loop by
    CUDA events, the bound the bytes it must move (a and b read, h
    written, h0 read where given)."""
    heaviest = None
    for (name, label, _), (args, kwargs) in families["seen"].items():
        if name == "rglru_scan" and (heaviest is None
                                     or args[0].numel() > heaviest[1][0].numel()):
            heaviest = (label, args, kwargs)
    label, args, kwargs = heaviest
    a, _, h0 = (list(args) + [None])[:3]
    kernel_fn, plain_fn = lm_kernel("rglru_scan"), lm_plain("rglru_scan")
    ms = cold_ms(lambda: kernel_fn(*args, **kwargs), 20)
    plain_ms = cuda_ms(lambda: plain_fn(*args, **kwargs), 2)
    nbytes = 4 * (3 * a.numel() + (0 if h0 is None else h0.numel()))
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = 2 * a.numel() / SCALAR_OPS_PER_S * 1e3
    B, S, dr = a.shape
    rec = {
        "name": "rglru_scan", "route": "cuda",
        "source": "src/repro_torch/csrc/rglru_scan.cu",
        "replaces": "none: no TPU kernel (jax.lax.associative_scan, "
                    "src/repro/models/layers.py:689)",
        "launches": int(families["launches"].get("rglru_scan", 0)),
        "max_abs_err": families["worst"]["rglru_scan"], "ms": ms,
        "plain_ms": plain_ms, "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None,
        "shape": f"a, b [{B},{S},{dr}] float32, h0 "
                 f"{'none' if h0 is None else list(h0.shape)} ({label})",
        "ms_from": "cuda events, cold: L2 flushed before each launch",
    }
    log(f"timing: rglru_scan at {rec['shape']}: kernel {ms:.4f} ms cold, "
        f"{ms / rec['bound_ms']:.2f}x its bound {rec['bound_ms']:.4f} ms ({nbytes} "
        f"bytes; operations {ops_ms:.4f} ms); plain {plain_ms:.4f} ms; no library "
        f"call (no torch call computes a linear recurrence); {rec['launches']} "
        f"launches in its phase; {device_line(CLOCK_FIELDS)}")
    return check_readings(rec)


def lm_timing(lm: dict) -> list:
    """Kernel records of the LM kernels at the heaviest shape each was
    launched at in the lm phase (by elements of its first operand, then
    by its width). The ssd record times the route that shape takes: the
    bf16 tensor-core route launches ``ssd_tc_kernel`` alone (x, dt, a_log,
    B and C read as the layer hands them over), the CUDA-core route copies
    its operands and launches ``ssd_fma_kernel``."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.ssd_scan import kernel_chunk, uses_tensor_cores

    heaviest = {}
    for (name, label, shapes), (args, kwargs) in lm["seen"].items():
        size = (args[0].numel(), args[0].shape[-1])  # ties: the wider row
        if name not in heaviest or size > heaviest[name][0]:
            heaviest[name] = (size, label, args, kwargs)
    records = []
    for name, source_name, replaces in (
        ("flash_attention", "flash_attention", "src/repro/kernels/flash_attention.py:92"),
        ("ssd_scan", "ssd_scan", "src/repro/kernels/ssd_scan.py:93"),
    ):
        _, label, args, kw = heaviest[name]
        kernel_fn, plain_fn = lm_kernel(name), lm_plain(name)
        kernel = lambda: kernel_fn(*args, **kw)  # noqa: E731
        plain = lambda: plain_fn(*args, **kw)  # noqa: E731
        el = args[0].element_size()
        library, library_none, iters = None, "", 10
        symbols, counter = ("flash_wgmma_kernel",), name
        if name == "flash_attention":
            q, k, v = args
            B, Hq, S, D = q.shape
            library = lambda: F.scaled_dot_product_attention(  # noqa: E731
                q, k, v, is_causal=kw["causal"], scale=kw["scale"],
                enable_gqa=True)
            nbytes = el * (2 * q.numel() + k.numel() + v.numel())
            ops_count = 4 * B * Hq * D * S * (S + 1) / 2
            rate = BF16_TENSOR_OPS_PER_S
            shape = (f"q [{B},{Hq},{S},{D}], kv [{B},{k.shape[1]},{S},{D}] "
                     f"{q.dtype}, strides {q.stride()} ({label})")
        else:
            x, dt, a_log, bm, cm = args
            B, H, S, P = x.shape
            N = bm.shape[-1]
            Q = kernel_chunk(kw["chunk"], S)
            if uses_tensor_cores(x.dtype, P, N, Q):
                symbols = ("ssd_tc_kernel",)
            else:
                symbols, counter = ("ssd_fma_kernel",), "ssd_scan_fma"
            nc = -(-S // Q)
            tri = Q * (Q + 1) / 2
            # per chunk and b*h: C Bt^T on the lower triangle, its product
            # with X, the inter-chunk term and the state pass (2 flops a MAC)
            ops_count = B * H * nc * 2 * (tri * N + tri * P + 2 * Q * N * P)
            nbytes = (2 * el * x.numel() + 4 * (dt.numel() + a_log.numel())
                      + bm.element_size() * (bm.numel() + cm.numel()))
            rate = BF16_TENSOR_OPS_PER_S
            library_none = "no torch call runs a chunked selective scan"
            shape = (f"x [{B * H},{S},{P}], B/C [{B},{S},{N}] {x.dtype}, chunk "
                     f"{Q} ({label})")
        records.append(kernel_record(
            name, symbols, f"src/repro_torch/csrc/{source_name}.cu", replaces,
            lm["launches"].get(counter, 0), lm["worst"][name], kernel, plain, iters,
            nbytes, ops_count, shape, ops_rate=rate, library=library,
            library_none=library_none,
        ))
        if name == "flash_attention":
            flash_grad_forward(kernel_fn, args, kw, shape)
        del kernel, plain, library
        torch.cuda.empty_cache()
    _, label, args, kw = heaviest["rmsnorm"]
    records.append(rmsnorm_timing(args, kw, label, lm))
    for (name, label, _), (args, kw) in lm["seen"].items():
        if name == "rmsnorm" and args[0].shape[-1] == QNORM_WIDTH:
            rmsnorm_timing(args, kw, label, lm)  # printed, not a record
            break
    return records


def flash_grad_forward(kernel_fn, args, kw, shape: str) -> None:
    """Prints the flash forward under grad (o_lo and lse written for the
    backward) beside an ordinary call at the same inputs, both cold."""
    ordinary = cold_ms(lambda: kernel_fn(*args, **kw), 10)
    grad = cold_ms(lambda: kernel_fn(*args, residuals=True, **kw), 10)
    log(f"lm: flash_attention forward at {shape}: under grad (o_lo and lse written) "
        f"{grad:.4f} ms cold, an ordinary call {ordinary:.4f} ms cold "
        f"({grad / ordinary:.3f}x); {device_line(CLOCK_FIELDS)}")


COLD_BUFFERS = 3  # input/output pairs of a cold rmsnorm timing
QNORM_WIDTH = 128  # qwen3's q/k norm: one row per head and token


def rmsnorm_timing(args, kw, label: str, lm: dict) -> dict:
    """The rmsnorm record at the shape of ``args``, kernel, plain version
    and ``F.rms_norm`` alike on COLD_BUFFERS copies of x and as many
    outputs held (384 MiB at the hidden shape), so the 50 MB L2 cannot
    serve the rows of one launch from the last."""
    import torch.nn.functional as F

    x, w = args
    D = x.shape[-1]
    R = x.numel() // D
    xs = [x] + [x.clone() for _ in range(COLD_BUFFERS - 1)]
    w1 = (w.float() + 1.0).to(x.dtype) if kw["plus_one"] else w.to(x.dtype)
    kernel_fn, plain_fn = lm_kernel("rmsnorm"), lm_plain("rmsnorm")
    kernel = rotating(lambda xi: kernel_fn(xi, w, **kw), [[xi] for xi in xs],
                      COLD_BUFFERS)
    plain = rotating(lambda xi: plain_fn(xi, w, **kw), [[xi] for xi in xs],
                     COLD_BUFFERS)
    library = rotating(lambda xi: F.rms_norm(xi, (D,), weight=w1, eps=kw["eps"]),
                       [[xi] for xi in xs], COLD_BUFFERS)
    el = x.element_size()
    return kernel_record(
        "rmsnorm", ("rmsnorm_kernel",), "src/repro_torch/csrc/rmsnorm.cu",
        "src/repro/kernels/rmsnorm.py:33", lm["launches"].get("rmsnorm", 0),
        lm["worst"]["rmsnorm"], kernel, plain, 50, 2 * el * x.numel() + 4 * D,
        4 * R * D,  # square, sum, two multiplies a value
        f"[{R},{D}] {x.dtype}, cold, {COLD_BUFFERS} buffers ({label})",
        library=library,
    )


# ---------------------------------------------------------------------------
# Training: the train: phase
# ---------------------------------------------------------------------------

TRAIN_ARCH = "qwen3-1.7b"  # launch/train.py's default --arch, published config
TRAIN_BATCH = 4
TRAIN_SEQ = 2048
TRAIN_STEPS = 4  # the resume check's 4 walk batches; each more costs 7-9 s
# AdamW's peak lr, 2 warmup steps, cosine to a tenth: a sweep at full width
# on an NVIDIA H100 80GB HBM3 at 700 W fell 0.105 nats over 6 steps at 1e-3
# and 0.055 at 3e-4 (both also on a held-out batch); launch/train.py's 3e-3
# with its 5-step warmup, meant for its reduced model, rose 0.257
TRAIN_LR = 1e-3
TRAIN_WARMUP = 2
TRAIN_RESUME_LAYERS = 2  # a state of all 28 layers is 27.5 GB of npz
TRAIN_RESUME_STEPS = 4  # without a break, then half, restore, half
TRAIN_SERVE_REQUESTS = 2
TRAIN_SERVE_PROMPT = 64
TRAIN_SERVE_NEW = 8
TRAIN_REL_TOL = 2.0**-6  # a backward kernel against its plain version in f32
TRAIN_FLOOR_TOL = 2.0**-10
TRAIN_F32_TOL = 1e-4  # the same in f32 at a small shape
# the SSD backward's f32 check adds this share of each gradient's largest to
# TRAIN_F32_TOL of each element (ddt and da_log sum hundreds of terms of
# either sign): on an H100 its worst errors were 1.4e-6 to 2.6e-6 of their
# gradients' largest (readings in PERF.md)
TRAIN_SSD_F32_FLOOR = 1e-5
TRAIN_F32_SHAPES = {"flash": (2, 4, 2, 256, 128), "rmsnorm": (512, 2048),
                    # S a multiple of neither the chunk (128) nor the
                    # backward's (64); h0 given to the RG-LRU
                    "ssd": (1, 3, 300, 64, 128, 128), "rglru": (2, 333, 1000)}
TRAIN_PHASE_LIMIT_S = 150.0
TRAIN_RECORDED = ("rmsnorm_bwd", "flash_attention_bwd")
TRAIN_KERNELS = ("rmsnorm", "flash_attention") + TRAIN_RECORDED
# train_scans: the two scan families, TRAIN_SCAN_STEPS AdamW steps of
# TRAIN_BATCH x TRAIN_SEQ synthetic tokens each (launch/train.py --data
# synthetic), the phase's schedule. recurrentgemma is cut to whole (R, R, A)
# groups plus its (R, R) tail (TRAIN_SCAN_LAYERS): all 38 layers hold 9.0B
# parameters, and weights, gradients and AdamW's f32 master and moments
# (2 + 2 + 12 bytes each) come to 150 GB, past the card's 80 GB; and at 8
# layers (2.83B parameters) a step ran out of it on the H100 (75 GB held when
# the cross-entropy's (8,192, 256,000) f32 logits asked for 7.8 GiB more), so
# 5: one group and the tail. Its cross-entropy goes in chunks of 2,048 tokens
# (TRAIN_SCAN_LOSS_CHUNK, Model.LOSS_CHUNK_TOKENS, each chunk's logits
# recomputed in the backward pass; the same function): whole, at 5 layers
# the step peaked at 79.8 GB with a 1M-node network on the card, and the
# smoke keeps its 10M-node network there (7 GB more at qwen3's peak).
TRAIN_SCAN_ARCHS = ("mamba2-130m", "recurrentgemma-9b")
TRAIN_SCAN_LAYERS = {"recurrentgemma-9b": 5}
TRAIN_SCAN_CUT_WHY = ("at 8 layers (2.83B parameters) a step ran out of the card's "
                      "memory: 75 GB held when the cross-entropy's f32 logits asked "
                      "for 7.8 GiB more")
TRAIN_SCAN_LOSS_CHUNK = {"recurrentgemma-9b": 2048}
TRAIN_SCAN_STEPS = 4
TRAIN_SCAN_BUDGET_S = 35.0  # the part's share of the phase, printed beside it
TRAIN_SCAN_RECORDED = ("ssd_scan_bwd", "rglru_scan_bwd")
TRAIN_SCAN_KERNELS = {
    "mamba": ("rmsnorm", "rmsnorm_bwd", "ssd_scan", "ssd_scan_bwd_states",
              "ssd_scan_bwd"),
    "rglru": ("rmsnorm", "rmsnorm_bwd", "rglru_scan", "rglru_scan_bwd"),
}
#: counts that must read 0 in a family's steps: mamba2's bf16 SSD backward
#: takes the tensor-core route and reads the layer's views uncopied
TRAIN_SCAN_ABSENT = {
    "mamba": ("ssd_scan_fma", "ssd_scan_bwd_states_fma", "ssd_scan_bwd_fma",
              "ssd_scan_bwd_copies"),
}
TRAIN_BITWISE = ("rglru_scan_bwd",)  # equal to its plain loop bit for bit
TRAIN_BYTES_A_PARAM = 16  # bf16 weight and gradient, f32 master, mu and nu


def train_opt_config(steps: int):
    """The phase's AdamW schedule for ``steps`` steps."""
    from repro_torch.train.optimizer import AdamWConfig

    return AdamWConfig(lr_peak=TRAIN_LR, lr_min=TRAIN_LR / 10,
                       warmup_steps=TRAIN_WARMUP, decay_steps=steps)


DRYRUN_MESHES = ("single", "multi")
DRYRUN_OK_A_MESH = 32  # 10 archs x 4 shapes, less the 8 full-attention long_500k
DRYRUN_SKIPS_A_MESH = 8


def phase_dryrun() -> None:
    """``repro_torch.launch.dryrun.run_cell`` for every cell of the 40-cell
    matrix on both production meshes (16x16 and 2x16x16 cards), on the
    meta device: each cell's parameter, optimizer and cache or carry bytes
    a card, whether they fit this card's memory, and the analytic step's
    bytes and least time a card. 32 cells a mesh must be ok and 8 skipped;
    a cell that raises fails the phase."""
    import torch

    from repro_torch.configs.shapes import all_cells
    from repro_torch.launch import dryrun

    t0 = time.perf_counter()
    cap = torch.cuda.get_device_properties(0).total_memory
    log(f"dryrun: every cell on the meta device against this card's {cap} bytes "
        f"({device_line()}); JSON under {dryrun.ART_DIR}")
    gib = 2**30
    for mesh in DRYRUN_MESHES:
        ok, skipped, errors = 0, 0, []
        for arch, shape, skip in all_cells(include_skipped=True):
            if skip:
                skipped += 1
                continue
            rec = dryrun.run_cell(arch, shape, mesh, capacity=cap)
            if rec["status"] != "ok":
                errors.append(f"{arch} {shape}: {rec['error']}")
                continue
            ok += 1
            pc, an = rec["per_card"], rec["analytic"]
            held = (f"optimizer {pc['optimizer_bytes'] / gib:.3f} GiB, carries "
                    f"{pc['carry_bytes'] / gib:.3f} GiB (accum {rec['accum_steps']})"
                    if rec["kind"] == "train" else f"cache {pc['cache_bytes'] / gib:.3f} GiB")
            log(f"dryrun: {mesh} ({rec['chips']} cards) {arch} {shape}: a card holds "
                f"parameters {pc['param_bytes'] / gib:.3f} GiB, {held}, "
                f"{pc['total_bytes'] / gib:.3f} GiB in all: "
                f"{'fits' if pc['fits'] else 'does not fit'}; a step's HBM bytes a card "
                f"{an['hbm_bytes_per_device']:.4g}, FLOPs "
                f"{an['flops']['total'] / rec['chips']:.4g}, at least "
                f"{an['bound_ms_per_device']:.3f} ms")
        if errors or ok != DRYRUN_OK_A_MESH or skipped != DRYRUN_SKIPS_A_MESH:
            raise AssertionError(f"dryrun: {mesh}: {ok} ok and {skipped} skipped (want "
                                 f"{DRYRUN_OK_A_MESH} and {DRYRUN_SKIPS_A_MESH}); "
                                 f"errors: {errors}")
        log(f"dryrun: {mesh}: {ok} cells ok, {skipped} skipped (full attention at "
            "500k)")
    log(f"dryrun: {time.perf_counter() - t0:.3f} s; {device_line()}")


def one_card_policy(cfg):
    """The sharding policy of the one card the phase trains on, as
    ``launch/train.py`` passes it (``make_policy(make_host_mesh(1), cfg)``):
    every mesh axis of size 1, so it places nothing."""
    from repro_torch.launch.mesh import make_host_mesh, make_policy

    policy = make_policy(make_host_mesh(1), cfg)
    if not policy.one_card:
        raise AssertionError(f"train: {cfg.name}: {policy} spans more than one card")
    return policy


def check_losses(label: str, losses: list) -> None:
    """Every step's loss finite, and the last below the first."""
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"train: {label}: a non-finite loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"train: {label}: the loss did not fall: {losses}")


def check_phase_time(phase: str, seconds: float, limit: float) -> None:
    if seconds > limit:
        raise AssertionError(f"{phase}: the phase took {seconds:.1f} s, over its "
                             f"{limit:g} s")


def bwd_plain(name: str, args, kwargs) -> list:
    """The plain version of a backward kernel's call -> [(output name,
    reference f32)]: f32 autograd of the forward's plain version, or for
    ``rglru_scan_bwd`` the plain loop its kernel must equal bit for bit
    (autograd needs b, which the kernel does not take; the CPU tests hold
    the loop against autograd). An output the call has not (dh0 without
    h0) is left out."""
    from repro_torch.kernels import ref

    if name == "rmsnorm_bwd":
        x, w, dy = args
        return list(zip(("dx", "dw"), ref.rmsnorm_bwd_ref(x, w, dy, **kwargs)))
    if name == "ssd_scan_bwd":
        return list(zip(("dx", "ddt", "da_log", "dB", "dC"),
                        ref.ssd_scan_bwd_ref(*args, **kwargs)))
    if name == "rglru_scan_bwd":
        return [(out, t) for out, t in zip(("da", "db", "dh0"),
                                           ref.rglru_scan_bwd_loop(*args))
                if t is not None]
    # flash: q, k, v, dO, then the forward's o, o_lo and lse on the
    # tensor-core route
    return list(zip(("dq", "dk", "dv"), ref.attention_bwd_ref(*args[:4], **kwargs)))


def bwd_kernel_checks(seen: dict) -> dict:
    """Each backward kernel against its plain version in f32, on the inputs
    the main path gave it (``KernelInputs``): every element of every output
    within TRAIN_REL_TOL of its reference value plus TRAIN_FLOOR_TOL of the
    reference's largest, and the same limit must reject a zeroed output and
    the reference rounded to LM_FAULT_BITS bits -> {kernel: max abs
    error}."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    worst, bad = {}, []
    for (name, label, shapes), (args, kwargs) in seen.items():
        got = lm_kernel(name)(*args, **kwargs)
        for (out, want), g in zip(bwd_plain(name, args, kwargs), got):
            g = g.float()
            err, ratio = lm_excess(g, want, TRAIN_REL_TOL, TRAIN_FLOOR_TOL)
            _, zero_ratio = lm_excess(torch.zeros_like(want), want, TRAIN_REL_TOL,
                                      TRAIN_FLOOR_TOL)
            _, coarse_ratio = lm_excess(round_bits(want, LM_FAULT_BITS), want,
                                        TRAIN_REL_TOL, TRAIN_FLOOR_TOL)
            ok = bool(torch.isfinite(g).all()) and ratio <= 1.0
            bitwise = ""
            if name in TRAIN_BITWISE:
                same = torch.equal(g, want)
                ok = ok and same
                bitwise = f"; bit-identical to its loop: {same}"
            caught = zero_ratio > 1.0 and coarse_ratio > 1.0
            worst[name] = max(worst.get(name, 0.0), err)
            log(f"train: {name} {out} at {[list(sh) for sh, _ in shapes]} "
                f"{shapes[0][1]} against its plain version in f32: max_abs_err "
                f"{err:.3e} (reference max {float(want.abs().max()):.3e}); worst ratio "
                f"to the limit {ratio:.3f} ({'ok' if ok else 'FAILS'}; limit "
                f"{TRAIN_REL_TOL:g} |ref| + {TRAIN_FLOOR_TOL:g} max |ref|){bitwise}; "
                f"planted faults: zeroed {zero_ratio:.3g}, rounded to {LM_FAULT_BITS} "
                f"bits {coarse_ratio:.3g} ({'both rejected' if caught else 'NOT REJECTED'})")
            if not ok or not caught:
                bad.append(f"{name}/{out}{[list(sh) for sh, _ in shapes]}")
        del got
    if bad:
        raise AssertionError(f"train: backward kernel checks failed: {bad}")
    return worst


def bwd_f32_checks(device, seed: int) -> None:
    """The backward kernels in f32 at a small shape against their plain
    versions: flash and rmsnorm within TRAIN_F32_TOL (rtol and atol); the
    SSD scan within TRAIN_F32_TOL of each element plus TRAIN_SSD_F32_FLOOR
    of the gradient's largest (ddt and da_log sum hundreds of terms of either
    sign), against f32 autograd; the RG-LRU scan, from a seeded h0, equal
    to its loop bit for bit and within TRAIN_F32_TOL of f32 autograd."""
    import torch

    from repro_torch.kernels import ref

    gen = torch.Generator(device=device).manual_seed(seed + 31)
    B, Hq, Hkv, S, D = TRAIN_F32_SHAPES["flash"]
    q, do = (torch.randn((B, Hq, S, D), generator=gen, device=device) for _ in range(2))
    k, v = (torch.randn((B, Hkv, S, D), generator=gen, device=device) for _ in range(2))
    R, W = TRAIN_F32_SHAPES["rmsnorm"]
    x, dy = (torch.randn((R, W), generator=gen, device=device) * 3 for _ in range(2))
    w = torch.randn((W,), generator=gen, device=device) * 0.1
    calls = {"flash_attention_bwd": ((q, k, v, do), {"scale": D**-0.5, "causal": True}),
             "rmsnorm_bwd": ((x, w, dy), {"eps": 1e-6, "plus_one": True})}
    for name, (args, kwargs) in calls.items():
        got = lm_kernel(name)(*args, **kwargs)
        for (out, want), g in zip(bwd_plain(name, args, kwargs), got):
            err = float((g - want).abs().max())
            log(f"train: {name} {out} f32 at {[list(a.shape) for a in args]}: max_abs_err "
                f"{err:.3e} (reference max {float(want.abs().max()):.3e}; limit "
                f"{TRAIN_F32_TOL:g} rtol and atol)")
            torch.testing.assert_close(g, want, rtol=TRAIN_F32_TOL, atol=TRAIN_F32_TOL)

    B, H, S, P, N, chunk = TRAIN_F32_SHAPES["ssd"]
    x, dy = (torch.randn((B, H, S, P), generator=gen, device=device) for _ in range(2))
    dt = torch.rand((B, H, S), generator=gen, device=device) * 0.5 + 0.01
    a_log = -dt * (torch.rand((1, H, 1), generator=gen, device=device) * 8 + 0.5)
    bm, cm = (torch.randn((B, S, N), generator=gen, device=device) for _ in range(2))
    args = (x, dt, a_log, bm, cm, dy)
    got = lm_kernel("ssd_scan_bwd")(*args, chunk=chunk)
    for (out, want), g in zip(bwd_plain("ssd_scan_bwd", args, {"chunk": chunk}), got):
        top = float(want.abs().max())
        err = float((g - want).abs().max())
        log(f"train: ssd_scan_bwd {out} f32 at x {[B, H, S, P]}, N {N}, chunk {chunk}: "
            f"max_abs_err {err:.3e} (reference max {top:.3e}, {err / top:.2e} of it; "
            f"limit {TRAIN_F32_TOL:g} |ref| + {TRAIN_SSD_F32_FLOOR:g} max |ref|)")
        torch.testing.assert_close(g, want, rtol=TRAIN_F32_TOL,
                                   atol=TRAIN_SSD_F32_FLOOR * top)

    B, S, dr = TRAIN_F32_SHAPES["rglru"]
    a = torch.rand((B, S, dr), generator=gen, device=device) * 0.5 + 0.5
    b, dh = (torch.randn((B, S, dr), generator=gen, device=device) for _ in range(2))
    h0 = torch.randn((B, dr), generator=gen, device=device)
    h = lm_kernel("rglru_scan")(a, b, h0)
    got = lm_kernel("rglru_scan_bwd")(a, h, h0, dh)
    loop = ref.rglru_scan_bwd_loop(a, h, h0, dh)
    autograd = ref.rglru_scan_bwd_ref(a, b, h0, dh)
    for out, g, lp, want in zip(("da", "db", "dh0"), got, loop, autograd):
        same = torch.equal(g, lp)
        err = float((g - want).abs().max())
        log(f"train: rglru_scan_bwd {out} f32 at [{B},{S},{dr}] from a seeded h0: "
            f"bit-identical to its loop: {same}; against f32 autograd max_abs_err "
            f"{err:.3e} (reference max {float(want.abs().max()):.3e}; limit "
            f"{TRAIN_F32_TOL:g} rtol and atol)")
        if not same:
            raise AssertionError(f"train: rglru_scan_bwd {out} differs from its loop")
        torch.testing.assert_close(g, want, rtol=TRAIN_F32_TOL, atol=TRAIN_F32_TOL)


class PlainScanCalls:
    """Within the block, counts the calls of the scans' plain versions, the
    CPU path of ``ops.ssd_scan`` and ``ops.rglru_scan``
    (``ref.ssd_scan_heads_ref``, ``ref.rglru_scan_ref``): on the card they
    must not run."""

    NAMES = ("ssd_scan_heads_ref", "rglru_scan_ref")

    def __enter__(self):
        from repro_torch.kernels import ref

        self.counts = dict.fromkeys(self.NAMES, 0)
        self._inner = {n: getattr(ref, n) for n in self.NAMES}

        def counter(name, inner):
            def run(*args, **kwargs):
                self.counts[name] += 1
                return inner(*args, **kwargs)
            return run

        for n, inner in self._inner.items():
            setattr(ref, n, counter(n, inner))
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import ref

        for n, inner in self._inner.items():
            setattr(ref, n, inner)


def step_parts(model, trainer, state, batch) -> dict:
    """One more AdamW step on ``batch``, timed in parts (ms): forward,
    backward, optimizer."""
    import torch

    from repro_torch.train.optimizer import adamw_update

    params = state["params"]
    sync()
    t1 = time.perf_counter()
    loss, _ = model.loss(batch)
    sync()
    t2 = time.perf_counter()
    grads = torch.autograd.grad(loss, list(params.values()))
    sync()
    t3 = time.perf_counter()
    master, _ = adamw_update(dict(zip(params, grads)), state["opt"], trainer.opt_cfg)
    del grads
    with torch.no_grad():
        for name, p in params.items():
            p.copy_(master[name])
    sync()
    t4 = time.perf_counter()
    return {"forward": (t2 - t1) * 1e3, "backward": (t3 - t2) * 1e3,
            "optimizer": (t4 - t3) * 1e3}


def scan_train_configs() -> dict:
    """TRAIN_SCAN_ARCHS' published configurations, each cut to its
    TRAIN_SCAN_LAYERS depth where it has one (the cut printed)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models.config import param_count

    configs = {}
    for arch in TRAIN_SCAN_ARCHS:
        cfg = get_config(arch)
        depth = TRAIN_SCAN_LAYERS.get(arch)
        if depth is not None and depth != cfg.n_layers:
            cut = dataclasses.replace(cfg, n_layers=depth).validate()
            log(f"train: {arch}: depth cut to {depth} of {cfg.n_layers} layers, "
                f"{(depth - len(cfg.tail_pattern)) // len(cfg.block_pattern)} "
                f"{tuple(cfg.block_pattern)} groups and the {tuple(cfg.tail_pattern)} "
                f"tail: all {cfg.n_layers} hold {param_count(cfg)} parameters, "
                f"{TRAIN_BYTES_A_PARAM * param_count(cfg)} bytes with gradients and "
                f"AdamW's f32 master and moments, past the card's {LM_CARD_BYTES:g}, "
                f"and {TRAIN_SCAN_CUT_WHY}; {depth} hold {param_count(cut)} "
                f"({TRAIN_BYTES_A_PARAM * param_count(cut)} bytes); widths and "
                f"vocabulary as published")
            cfg = cut
        configs[arch] = cfg
    return configs


def train_scan_family(cfg, device, seed: int) -> dict:
    """TRAIN_SCAN_STEPS AdamW steps of ``cfg`` through ``Trainer.train_step``
    on ``synthetic_batch_at`` batches of TRAIN_BATCH x TRAIN_SEQ tokens,
    launch counts set to 0 just before and read just after, the scans'
    backward inputs recorded and their plain versions counted; then one
    more step timed in parts."""
    import torch

    from repro_torch.data.pipeline import synthetic_batch_at
    from repro_torch.kernels import build
    from repro_torch.models.model import Model
    from repro_torch.train.train_loop import Trainer, TrainerConfig

    t0 = time.perf_counter()
    model = Model(cfg, device=device)
    if cfg.name in TRAIN_SCAN_LOSS_CHUNK:
        model.LOSS_CHUNK_TOKENS = TRAIN_SCAN_LOSS_CHUNK[cfg.name]
        log(f"train: {cfg.name}: the cross-entropy in chunks of "
            f"{model.LOSS_CHUNK_TOKENS} tokens, each recomputed in the backward pass "
            f"(whole, its f32 logits over a vocabulary of {cfg.vocab_size} took the "
            f"step to 79.8 GB at 5 layers beside a 1M-node network)")
    trainer = Trainer(model, train_opt_config(TRAIN_SCAN_STEPS),
                      TrainerConfig(steps=TRAIN_SCAN_STEPS, seed=seed),
                      policy=one_card_policy(cfg))
    state = trainer.init_state(seed)
    batches = [synthetic_batch_at(step, seed=seed, batch_size=TRAIN_BATCH,
                                  seq_len=TRAIN_SEQ, vocab_size=cfg.vocab_size,
                                  device=device)
               for step in range(TRAIN_SCAN_STEPS)]
    sync()
    n_params = sum(p.numel() for p in state["params"].values())
    log(f"train: {cfg.name} ({cfg.n_layers} layers, d_model {cfg.d_model}, vocab "
        f"{cfg.vocab_size}, {cfg.dtype}, remat {cfg.remat}): {n_params} parameters, "
        f"built, drawn and {TRAIN_SCAN_STEPS} synthetic batches made in "
        f"{time.perf_counter() - t0:.3f} s")
    torch.cuda.reset_peak_memory_stats()
    build.launch_counts.clear()
    losses, step_ms = [], []
    with KernelInputs("train", TRAIN_SCAN_RECORDED) as rec, PlainScanCalls() as plain:
        for step in range(TRAIN_SCAN_STEPS):
            sync()
            t1 = time.perf_counter()
            state, metrics = trainer.train_step(state, batches[step])
            losses.append(float(metrics["loss"]))
            step_ms.append((time.perf_counter() - t1) * 1e3)
            log(f"train: {cfg.name} step {step + 1}: loss {losses[-1]:.6f}, "
                f"{step_ms[-1]:.1f} ms")
    launches = dict(build.launch_counts)
    peak = torch.cuda.max_memory_allocated()
    tokens = TRAIN_BATCH * TRAIN_SEQ
    med = statistics.median(step_ms[1:] if len(step_ms) > 1 else step_ms)
    log(f"train: {cfg.name} launch counts {json.dumps(launches, sort_keys=True)}; "
        f"plain scan calls {json.dumps(plain.counts, sort_keys=True)}")
    log(f"train: {cfg.name}: {TRAIN_SCAN_STEPS} steps of {tokens} tokens: median "
        f"{med:.1f} ms a step after the first ({step_ms[0]:.1f} ms), "
        f"{tokens / med * 1e3:.1f} tokens/s; max_memory_allocated {peak} "
        f"({peak / 1e9:.2f} GB); {device_line()}")
    check_losses(cfg.name, losses)
    if any(plain.counts.values()):
        raise AssertionError(f"train: {cfg.name}: a scan's plain version ran on the "
                             f"card: {plain.counts}")
    kinds = set(cfg.block_pattern) | set(cfg.tail_pattern)
    assert_launched(f"train {cfg.name}", launches, sorted(
        {k for kind in kinds & set(TRAIN_SCAN_KERNELS) for k in TRAIN_SCAN_KERNELS[kind]}))
    for key in sorted({k for kind in kinds & set(TRAIN_SCAN_ABSENT)
                       for k in TRAIN_SCAN_ABSENT[kind]}):
        if launches.get(key, 0):
            raise AssertionError(f"train: {cfg.name}: {key} read {launches[key]}: the "
                                 "bf16 SSD scan must take the tensor-core routes and read "
                                 "the layer's views uncopied")
    split = step_parts(model, trainer, state, batches[0])
    log(f"train: {cfg.name} one step in parts (ms): {json.dumps(split)}")
    del model, trainer, state, batches
    torch.cuda.empty_cache()
    return {"losses": losses, "step_ms": step_ms, "launches": launches, "peak": peak,
            "seen": rec.seen, "split": split}


def train_scans(device, seed: int, configs: dict | None = None) -> dict:
    """Both scan families trained on the card (``train_scan_family``), each
    at ``configs[arch]`` (``scan_train_configs()`` by default) -> their
    runs, the launches summed and the recorded backward inputs."""
    import collections

    t0 = time.perf_counter()
    configs = configs or scan_train_configs()
    runs, launches, seen = {}, collections.Counter(), {}
    for arch, cfg in configs.items():
        runs[arch] = train_scan_family(cfg, device, seed)
        launches.update(runs[arch]["launches"])
        seen.update(runs[arch]["seen"])
    seconds = time.perf_counter() - t0
    log(f"train: train_scans: {', '.join(configs)} trained in {seconds:.3f} s "
        f"(budget {TRAIN_SCAN_BUDGET_S:g} s)")
    return {"runs": runs, "launches": dict(launches), "seen": seen,
            "seconds": seconds}


def train_full(batch_at, cfg, device, seed: int) -> dict:
    """TRAIN_STEPS AdamW steps of ``cfg`` at full width through
    ``Trainer.train_step`` on the walk batches ``batch_at(step)``, launch counts set to 0 just
    before and read just after, the backward kernels' inputs recorded; then
    one more step timed in parts (forward, backward, optimizer)."""
    import torch

    from repro_torch.kernels import build
    from repro_torch.models.model import Model
    from repro_torch.train.train_loop import Trainer, TrainerConfig

    t0 = time.perf_counter()
    model = Model(cfg, device=device)
    trainer = Trainer(model, train_opt_config(TRAIN_STEPS),
                      TrainerConfig(steps=TRAIN_STEPS, seed=seed),
                      policy=one_card_policy(cfg))
    state = trainer.init_state(seed)
    sync()
    n_params = sum(p.numel() for p in state["params"].values())
    log(f"train: {cfg.name} ({cfg.n_layers} layers, d_model {cfg.d_model}, vocab "
        f"{cfg.vocab_size}, {cfg.dtype}, remat {cfg.remat}): {n_params} parameters, "
        f"built and drawn in {time.perf_counter() - t0:.3f} s")
    torch.cuda.reset_peak_memory_stats()
    build.launch_counts.clear()
    losses, step_ms = [], []
    with KernelInputs("train", TRAIN_RECORDED) as rec:
        for step in range(TRAIN_STEPS):
            batch = batch_at(step)
            sync()
            t1 = time.perf_counter()
            state, metrics = trainer.train_step(state, batch)
            losses.append(float(metrics["loss"]))
            step_ms.append((time.perf_counter() - t1) * 1e3)
            log(f"train: step {step + 1}: loss {losses[-1]:.6f}, {step_ms[-1]:.1f} ms")
    launches = dict(build.launch_counts)
    peak = torch.cuda.max_memory_allocated()
    tokens = TRAIN_BATCH * TRAIN_SEQ
    med = statistics.median(step_ms[1:] if len(step_ms) > 1 else step_ms)
    log(f"train: launch counts {json.dumps(launches, sort_keys=True)}")
    log(f"train: {TRAIN_STEPS} steps of {tokens} tokens: median {med:.1f} ms a step "
        f"after the first ({step_ms[0]:.1f} ms), {tokens / med * 1e3:.1f} tokens/s; "
        f"max_memory_allocated {peak} ({peak / 1e9:.2f} GB); {device_line()}")
    check_losses(cfg.name, losses)
    assert_launched("train", launches, TRAIN_KERNELS)
    for key in ("flash_attention_fma", "flash_attention_bwd_fma",
                "flash_attention_copies", "flash_attention_bwd_copies"):
        if launches.get(key, 0):
            raise AssertionError(f"train: {key} read {launches[key]}: bf16 attention at "
                                 "head dim 128 must take the tensor-core routes and "
                                 "read the layer's layout uncopied")

    split = step_parts(model, trainer, state, batch_at(0))
    log(f"train: one step in parts (ms): {json.dumps(split)}")
    del model, trainer, state
    torch.cuda.empty_cache()
    return {"losses": losses, "step_ms": step_ms, "launches": launches, "peak": peak,
            "seen": rec.seen, "calls": rec.calls, "split": split}


def train_resume(batch_at, cfg, device, seed: int) -> None:
    """TRAIN_RESUME_STEPS steps at TRAIN_RESUME_LAYERS layers (full width and
    vocabulary) without a break, then half of them through ``Trainer.fit``,
    a new trainer that restores the committed checkpoint and runs the rest:
    the parameters and master weights must be equal bit for bit. Then
    ``launch/serve.py``'s restore path serves TRAIN_SERVE_NEW greedy tokens
    from that checkpoint; the first must be ``Model.apply``'s argmax."""
    import dataclasses
    import tempfile

    import torch

    from repro_torch.launch.serve import restore_params
    from repro_torch.models.lm_serve import Request, ServeEngine
    from repro_torch.models.model import Model
    from repro_torch.train.train_loop import Trainer, TrainerConfig

    cut = dataclasses.replace(cfg, n_layers=TRAIN_RESUME_LAYERS)
    opt_cfg = train_opt_config(TRAIN_RESUME_STEPS)
    half = TRAIN_RESUME_STEPS // 2

    def trainer_at(steps: int, ckpt_dir: str) -> Trainer:
        return Trainer(Model(cut, device=device), opt_cfg, TrainerConfig(
            steps=steps, ckpt_dir=ckpt_dir, ckpt_every=half, log_every=1,
            keep_ckpts=1, seed=seed), policy=one_card_policy(cut))

    with tempfile.TemporaryDirectory(prefix="train_resume_") as tmp:
        t0 = time.perf_counter()
        tr = trainer_at(TRAIN_RESUME_STEPS, tmp)
        state = tr.init_state(seed)
        for step in range(TRAIN_RESUME_STEPS):
            state, _ = tr.train_step(state, batch_at(step))
        want = {k: {n: t.detach().cpu() for n, t in tree.items()} for k, tree in
                (("params", state["params"]), ("master", state["opt"]["master"]))}
        del tr, state
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        trainer_at(half, tmp).fit(None, batch_at)
        t2 = time.perf_counter()
        tr = trainer_at(TRAIN_RESUME_STEPS, tmp)
        state, _ = tr.fit(None, batch_at)
        t3 = time.perf_counter()
        differ = [f"{k}/{n}" for k, tree in (("params", state["params"]),
                                              ("master", state["opt"]["master"]))
                  for n, t in tree.items() if not torch.equal(t.detach().cpu(), want[k][n])]
        files = sorted(p.name for p in Path(tmp).iterdir())
        nbytes = sum(f.stat().st_size for f in Path(tmp).rglob("*") if f.is_file())
        log(f"train: resume at {TRAIN_RESUME_LAYERS} of {cfg.n_layers} layers: "
            f"{TRAIN_RESUME_STEPS} steps unbroken {t1 - t0:.3f} s; {half} steps and a "
            f"checkpoint {t2 - t1:.3f} s; restore, {TRAIN_RESUME_STEPS - half} steps and "
            f"a checkpoint {t3 - t2:.3f} s; checkpoint directory {files}, {nbytes} "
            f"bytes; {len(differ)} of {2 * len(want['params'])} tensors differ")
        if differ:
            raise AssertionError(f"train: the resumed run differs from the unbroken "
                                 f"one: {differ[:8]}")
        del tr, state
        torch.cuda.empty_cache()

        model = Model(cut, device=device)
        step = restore_params(model, tmp)
        bad = [n for n, p in model.named_parameters()
               if not torch.equal(p.detach().cpu(), want["params"][n])]
        if step != TRAIN_RESUME_STEPS or bad:
            raise AssertionError(f"train: serving restored step {step}, params "
                                 f"differing: {bad[:8]}")
    prompts = np.random.default_rng(seed + 33).integers(
        2, cfg.vocab_size, (TRAIN_SERVE_REQUESTS, TRAIN_SERVE_PROMPT))
    reqs = [Request(prompt=p, max_new_tokens=TRAIN_SERVE_NEW, rid=i)
            for i, p in enumerate(prompts)]
    outs = ServeEngine(model, max_seq=TRAIN_SERVE_PROMPT + TRAIN_SERVE_NEW,
                       seed=seed).generate(reqs)
    with torch.no_grad():
        logits = model.apply(torch.from_numpy(prompts).to(device))[0][:, -1]
    first = torch.argmax(logits.float(), dim=-1).cpu().numpy()
    served = np.array([o.tokens[0] for o in outs])
    log(f"train: served {TRAIN_SERVE_NEW} greedy tokens a request from the step "
        f"{step} checkpoint: {[o.tokens.tolist() for o in outs]}; Model.apply's "
        f"argmax {first.tolist()}")
    if not np.array_equal(served, first):
        raise AssertionError("train: the first served token is not Model.apply's argmax")
    del model
    torch.cuda.empty_cache()


def phase_train(net, device, seed: int, cfg=None, scan_configs=None) -> dict:
    """Training on the card (``cfg``: TRAIN_ARCH's published config by
    default): ``train_full`` on walk-corpus batches of the phase's network
    (all its layers, TRAIN_BATCH x TRAIN_SEQ tokens), ``train_resume``, the
    scan families (``train_scans`` at ``scan_configs``), the backward
    kernels against their plain versions on the recorded inputs and in
    f32. Fails past TRAIN_PHASE_LIMIT_S."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import WalkCorpus, WalkCorpusConfig

    t0 = time.perf_counter()
    cfg = cfg or get_config(TRAIN_ARCH)
    corpus = WalkCorpus(net, WalkCorpusConfig(seed=seed, batch_size=TRAIN_BATCH,
                                              seq_len=TRAIN_SEQ),
                        vocab_size=cfg.vocab_size)
    # drawn before the steps: a walk's host loop beside a step would hold
    # the interpreter lock that the step's autograd Functions wait for
    batches = []
    for step in range(max(TRAIN_STEPS, TRAIN_RESUME_STEPS)):
        t1 = time.perf_counter()
        batches.append(corpus.batch_at(step))
        sync()
        log(f"train: walk-corpus batch {step} ({TRAIN_BATCH} walks of {TRAIN_SEQ} "
            f"nodes over the {len(net.layer_names)} layers) drawn in "
            f"{time.perf_counter() - t1:.3f} s")
    full = train_full(batches.__getitem__, cfg, device, seed)
    train_resume(batches.__getitem__, cfg, device, seed)
    scans = train_scans(device, seed, scan_configs)
    t1 = time.perf_counter()
    worst = bwd_kernel_checks({**full["seen"], **scans["seen"]})
    bwd_f32_checks(device, seed)
    seconds = time.perf_counter() - t0
    log(f"train: worst backward errors {json.dumps(worst, sort_keys=True)}; checks "
        f"{seconds - (t1 - t0):.3f} s; phase {seconds:.3f} s (limit "
        f"{TRAIN_PHASE_LIMIT_S:g} s); {device_line()}")
    check_phase_time("train", seconds, TRAIN_PHASE_LIMIT_S)
    return {**full, "worst": worst, "seconds": seconds, "scans": scans}


def train_timing(train: dict) -> list:
    """The backward kernels' records at the heaviest shape the train phase
    recorded (by elements of the first operand, then its width): the kernel
    and the library call cold (CUDA events, the L2 flushed before each
    launch), the plain version by CUDA events, and a second launch on the
    same inputs that must give the same bits. Bounds: flash's operations,
    2.5 times the forward's causal flops at the bf16 tensor-core peak;
    rmsnorm's bytes, x, w and dy read and dx written; the SSD scan's larger
    of its bytes (every operand read once, every gradient written once) and
    2.5 times the chunked products at the chunk the backward runs
    (``bwd_chunk``) at the bf16 tensor-core peak;
    the RG-LRU's bytes, a, h, dh (and h0) read and da, db (and dh0)
    written."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.ssd_scan import bwd_chunk, bwd_uses_tensor_cores, kernel_chunk

    heaviest = {}
    seen = {**train["seen"], **train["scans"]["seen"]}
    launches = collections.Counter(train["launches"])
    launches.update(train["scans"]["launches"])
    for (name, label, _), (args, kwargs) in seen.items():
        size = (args[0].numel(), args[0].shape[-1])
        if name not in heaviest or size > heaviest[name][0]:
            heaviest[name] = (size, label, args, kwargs)
    entries = [(name, None) + heaviest[name][1:]
               for name in TRAIN_RECORDED + TRAIN_SCAN_RECORDED]
    # rmsnorm_bwd at qwen3's q/k-norm width too: by elements its heaviest
    # call ties with the hidden norm's, which the choice above keeps
    narrow = sorted(((args[0].numel(), label, args, kw) for (name, label, _), (args, kw)
                     in seen.items() if name == "rmsnorm_bwd"
                     and args[0].shape[-1] == QNORM_WIDTH), key=lambda e: e[0])
    narrow_calls = sum(n for (name, _, shapes), n in train.get("calls", {}).items()
                       if name == "rmsnorm_bwd" and shapes[0][0][-1] == QNORM_WIDTH)
    if narrow and heaviest["rmsnorm_bwd"][2][0].shape[-1] != QNORM_WIDTH:
        at = [e[0] for e in entries].index("rmsnorm_bwd")
        entries[at] = entries[at][:1] + ("wide",) + entries[at][2:]
        entries.insert(at + 1, ("rmsnorm_bwd", "narrow") + narrow[-1][1:])
    records = []
    for name, part, label, args, kw in entries:
        kernel_fn = lm_kernel(name)
        el = args[0].element_size()
        library, source = None, name
        replaces = ("none: no TPU kernel (the JAX package differentiates its plain "
                    "path; forward {})")
        launches_of = int(launches.get(name, 0))
        if name == "flash_attention_bwd":
            q, k, v, do = args[:4]
            B, Hq, S, D = q.shape
            qr, kr, vr = (t.detach().requires_grad_(True) for t in (q, k, v))
            out = F.scaled_dot_product_attention(qr, kr, vr, is_causal=kw["causal"],
                                                 scale=kw["scale"], enable_gqa=True)
            library = lambda: torch.autograd.grad(  # noqa: E731
                out, (qr, kr, vr), do, retain_graph=True)
            nbytes = el * 3 * (q.numel() + k.numel())  # q, dO, dq; k, v, dk, dv
            if len(args) > 4 and args[4] is not None:  # the forward's o, o_lo, lse
                nbytes += 2 * el * q.numel() + 4 * B * Hq * S
            ops_count = 2.5 * 4 * B * Hq * D * S * (S + 1) / 2
            rate = BF16_TENSOR_OPS_PER_S
            shape = (f"q [{B},{Hq},{S},{D}], kv [{B},{k.shape[1]},{S},{D}] {q.dtype}, "
                     f"strides {q.stride()} ({label})")
            replaces = replaces.format("src/repro/kernels/flash_attention.py:92")
        elif name == "rmsnorm_bwd":
            x, w, dy = args
            R, D = x.numel() // x.shape[-1], x.shape[-1]
            xr = x.detach().requires_grad_(True)
            w1 = ((w.float() + 1.0) if kw["plus_one"] else w.float()).to(x.dtype)
            w1 = w1.requires_grad_(True)
            out = F.rms_norm(xr, (D,), weight=w1, eps=kw["eps"])
            library = lambda: torch.autograd.grad(  # noqa: E731
                out, (xr, w1), dy, retain_graph=True)
            nbytes = el * 3 * x.numel() + 4 * D
            ops_count = 8 * R * D
            rate = SCALAR_OPS_PER_S
            shape = f"[{R},{D}] {x.dtype}, cold ({label})"
            if part == "narrow":
                launches_of = narrow_calls
                shape += f"; launches: width {QNORM_WIDTH}"
            elif part == "wide":
                launches_of -= narrow_calls
                shape += f"; launches: every width but {QNORM_WIDTH}"
            replaces = replaces.format("src/repro/kernels/rmsnorm.py:33")
            source = "rmsnorm"
        elif name == "ssd_scan_bwd":
            x, dt, a_log, bm, cm, dy = args
            B, H, S, P = x.shape
            N = bm.shape[-1]
            Q = bwd_chunk(kw["chunk"], S, N, P)
            tri = Q * (Q + 1) / 2
            ops_count = 2.5 * B * H * -(-S // Q) * 2 * (tri * N + tri * P + 2 * Q * N * P)
            rate = BF16_TENSOR_OPS_PER_S
            # x, dy, dx; dt, a_log, ddt, da_log; B, C, dB, dC
            nbytes = 3 * el * x.numel() + 16 * dt.numel() + 4 * el * bm.numel()
            route = "tensor cores" if bwd_uses_tensor_cores(x.dtype, P, N) else "FMA"
            shape = (f"x [{B},{H},{S},{P}], B/C [{B},{S},{N}] {x.dtype}, the backward's "
                     f"chunk {Q} (the forward's {kernel_chunk(kw['chunk'], S)}), {route} "
                     f"route, cold ({label})")
            replaces = replaces.format("src/repro/kernels/ssd_scan.py:93")
        else:
            a, h, h0, dh = args
            B, S, dr = a.shape
            nbytes = 4 * 5 * a.numel() + (0 if h0 is None else 8 * h0.numel())
            ops_count = 3 * a.numel()
            rate = SCALAR_OPS_PER_S
            shape = (f"a, h, dh [{B},{S},{dr}] float32, h0 "
                     f"{'none' if h0 is None else list(h0.shape)}, cold ({label})")
            replaces = ("none: no TPU kernel (the JAX package differentiates "
                        "jax.lax.associative_scan, src/repro/models/layers.py:689)")
            source = "rglru_scan"
        first = kernel_fn(*args, **kw)
        second = kernel_fn(*args, **kw)
        same = all(f is None or torch.equal(f, g) for f, g in zip(first, second))
        del first, second
        if not same:
            raise AssertionError(f"timing: {name}: a second launch on the same inputs "
                                 "gave other bits")
        ms = cold_ms(lambda: kernel_fn(*args, **kw), 10)
        if name == "ssd_scan_bwd" or (name == "flash_attention_bwd" and len(args) > 4):
            bwd_split(name, lambda: kernel_fn(*args, **kw))
        library_ms = None if library is None else cold_ms(library, 10)
        # the same two readings with the card spun ahead of the host, so the
        # events hold device time only (printed beside, not recorded): the
        # gap to the reading above is the wrapper's host time
        device_only = [cold_ms(f, 10, host_ahead=True) for f in
                       (lambda: kernel_fn(*args, **kw), library) if f is not None]
        plain_ms = cuda_ms(lambda: bwd_plain(name, args, kw), 2)
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = ops_count / rate * 1e3
        rec = {
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{source}.cu",
            "replaces": replaces, "launches": launches_of,
            "max_abs_err": train["worst"][name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": library_ms, "shape": shape,
            "ms_from": "cuda events, cold: L2 flushed before each launch",
        }
        lib = ("no library call (no torch call computes this gradient)"
               if library_ms is None else f"library {library_ms:.4f} ms cold")
        log(f"timing: {name} at {shape}: kernel {ms:.4f} ms cold, "
            f"{ms / rec['bound_ms']:.2f}x its bound {rec['bound_ms']:.4f} ms "
            f"({rec['bound_by']}: bytes {bytes_ms:.4f}, operations {ops_ms:.4f}); plain "
            f"{plain_ms:.4f} ms; {lib}; device time only (the card spun ahead of the "
            f"host): kernel {' library '.join(f'{t:.4f}' for t in device_only)} ms; "
            f"a second launch bit-identical; "
            f"{rec['launches']} launches in the train phase; {device_line(CLOCK_FIELDS)}")
        records.append(check_readings(rec))
        del library
        torch.cuda.empty_cache()
    return records


#: the backward kernels whose device time ``bwd_split`` prints apart
BWD_SPLIT_KERNELS = {
    "ssd_scan_bwd": ("ssd_bwd_tc_states_kernel", "ssd_bwd_tc_grads_kernel"),
    "flash_attention_bwd": ("flash_bwd_dd_kernel", "flash_bwd_dkdv_kernel",
                            "flash_bwd_dq_kernel"),
}


def bwd_split(name: str, call) -> None:
    """Prints the device time of a backward's kernels apart (the profiler,
    3 calls after a warm-up), or "not measured" where the window lost
    them."""
    try:
        acts = device_activity(call, 3)
    except ProfilerLostEvents:
        log(f"timing: {name} kernels apart: not measured (profiler lost the window)")
        return
    parts = {k: [0, 0.0] for k in BWD_SPLIT_KERNELS[name]}
    for act, (n, us) in acts.items():
        for k, tally in parts.items():
            if k in act:
                tally[0] += n
                tally[1] += us
    log(f"timing: {name} kernels apart (profiler, warm): " + ", ".join(
        f"{k} {us / max(n, 1) / 1e3:.4f} ms a call ({n} events)"
        for k, (n, us) in parts.items()))


def run() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from repro_torch.kernels import build

    t_start = time.perf_counter()
    device = torch.device("cuda")
    log(device_line())  # name, power limit: as nvidia-smi prints them
    log(f"device: torch {torch.__version__} cuda {torch.version.cuda}, "
        f"{torch.cuda.device_count()} visible")

    secs = build.build(verbose=True)  # prints nvcc's register/spill report
    log(f"build: kernels {', '.join(build.KERNEL_SOURCES)} built in {secs:.3f} s")

    worst = phase_kernels(device, SEED)

    cut = "no cut" if N_NODES >= 10_000_000 else "cut; recipe per node kept"
    log(f"scale: n_nodes={N_NODES} ({cut})")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    net, median_income = build_network(N_NODES, SEED, device)
    sync()
    memberships = sum(net.layer(nm).n_memberships for nm, _, _ in LAYER_RECIPE)
    log(f"network: {N_NODES} nodes, {memberships} memberships, built in "
        f"{time.perf_counter() - t0:.3f} s; device bytes held {net.nbytes}, "
        f"max_memory_allocated {torch.cuda.max_memory_allocated()}")

    build.launch_counts.clear()
    with count_launches() as counted:
        latencies, queries = main_path(net, median_income, SEED, device)
        sync()
    launches = dict(build.launch_counts)
    log(f"main: launch counts {json.dumps(launches, sort_keys=True)}; "
        "count-only union shapes (rows, width): " + ", ".join(
            f"{k}x{v}" for k, v in sorted(counted.shapes.items())))
    assert_launched("main", launches, ("intersect_rows", "segmented_union",
                                       "segmented_union_count"))
    if launches.get("intersect_count", 0):
        raise AssertionError("the padded-row intersect entry launched on the main path")
    assert_no_sort_rows("main", launches)
    log(f"main: latencies ms {json.dumps(latencies, sort_keys=True)}")

    def mark(phase: str) -> None:  # where the smoke's time goes, phase by phase
        log(f"elapsed: {time.perf_counter() - t_start:.1f} s after {phase}")

    mark("main")
    panel = phase_panel(net, SEED, device)
    phase_oracle(net, panel["net"], median_income, SEED, device)
    mark("panel and oracle")
    phase_hubs(net, median_income, device)
    traversal = phase_traversal(net, median_income, SEED, device)
    mark("hubs and traversal")
    sampling = phase_sampling(net, median_income, SEED, device)
    mark("sampling")
    phase_storage(net, median_income, SEED, device)
    mark("storage")
    phase_serving(net, median_income, device)
    mark("serving")
    sharded = phase_sharded(net, median_income, SEED, device)
    mark("sharded")
    lm = phase_lm(device, SEED)
    mark("lm")
    families = phase_lm_families(device, SEED)
    mark("lm_families")
    train = phase_train(net, device, SEED)
    mark("train")
    phase_dryrun()
    mark("dryrun")
    records = phase_timing(net, queries, SEED, launches, worst, counted.heaviest,
                           panel, traversal, sampling, lm, device)
    for rec in records:  # the launch columns include the later phases'
        for later in (sharded, families, train, train["scans"]):
            rec["launches"] += later["launches"].get(rec["name"], 0)
    records.append(rglru_timing(families))
    records[-1]["launches"] += train["scans"]["launches"].get("rglru_scan", 0)
    log("timing: launches with the sharded, lm_families and train phases' added: "
        + ", ".join(f"{r['name']} {r['launches']}" for r in records))
    records.extend(train_timing(train))
    log(f"elapsed: {time.perf_counter() - t_start:.3f} s")
    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(run())
