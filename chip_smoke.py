#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's paths on one GPU and check them.

    python3 chip_smoke.py

The main path: DSL text -> soda_tpu_torch.build_stencil (the port's own
front half: parser, passes, fusion plan) -> soda_tpu_torch.get_executor
-> one generated CUDA C++ kernel per stencil. Beside it, grouped
execution (``cluster: coarse``: one kernel per stage group), replicated
execution (R grids in one launch), the command line, the whole-grid
executor, sharded execution over a device mesh (the fused kernel per
halo-extended shard; in one process, and one process a shard over
``torch.distributed``), the kernel's modes and layout forms and the
tools. Phases, each printing one line per step with its
seconds:

1. device: a CUDA device is required (no CPU fallback); prints the card,
   its power limit and the toolchain; neither jax nor the JAX package
   may be loaded (checked again at the end).
2. build: builds the 12 cells of the stencil benchmark (the 11 corpus
   kernels plus jacobi3d at 256^3, with the benchmark's shapes and
   stencil overrides), the grouped cells' per-group kernels, the small
   replicated grid's kernel and the sharded cells' kernels at their
   halo-extended shard shapes, the mode, tuner, layout and gate kernels,
   phase 26's options and their old kernels, phase 28's programs,
   the five hand-written probe sources (``probes.SOURCES``) and the fused
   kernels phases 17 and 18 run: one nvcc per source, all at once. Each
   cell must dispatch to the fused kernel under 'auto'.
3. main path: every cell once through ``executor(inputs)``, with every
   launch counter reset just before and read just after.
4. kernel vs plain: each kernel against its plain PyTorch version
   (``fused_stencil_plain``, whole grid as one tile) on the same card,
   on every output's valid region: integers bit-exact, floats within the
   reference's squared-error threshold (1e-4; contrast 1e-3).
5. oracle: blur at (8192, 2048) bit-exact against the NumPy oracle.
6. times: CUDA-event times of kernel and plain version per cell, each
   call from a cold L2 cache (median, and the kernel's quartiles), the
   unique-traffic rate (inputs read once, outputs written once) and the
   bound (that traffic over the card's spec memory rate, or the
   operations over its float32 rate, whichever is larger).
7. host: per cell, the host's microseconds to enqueue one ``executor.fn``
   call against the device's microseconds per call, over 200
   back-to-back calls (warm L2): whether the host holds the card back.
8. grouped: blur, sobel2d, denoise2d and heat3d under ``cluster: coarse``
   at their benchmark shapes through ``get_executor``, counters reset
   just before: one launch per group; held against the ungrouped plain
   version and the grouped plain version on the original valid regions;
   blur bit-exact against the NumPy oracle; times.
9. replicated: blur, jacobi2d and heat3d with R = 4 at their benchmark
   shapes, each replica its own inputs, and blur at (1024, 2048) with
   R = 16: one launch per call, each replica against the plain version;
   times, and the R = 16 launch against 16 single launches.
   Then blur at (1024, 2048) with R = 16 on a (4,) mesh that repeats the
   card: one launch of 4 grids per mesh entry, every replica == plain.
10. CLI: ``python -m soda_tpu_torch FILE --run`` for blur (``--bench``),
   denoise2d (``--cluster coarse``), jacobi2d (``--backend replicated
   --replication-factor 4``, and ``--backend xla``) and blur
   (``--backend sharded`` on the default mesh: the visible cards, the
   fused kernel per shard) at (8192, 2048): each exits 0, prints
   ``INFO: PASS!`` and reports its kernel launches: none for
   ``--backend xla``, at least one for every other run.
11. whole-grid: the 12 cells through ``get_executor(..., 'xla')`` (the
   plain version over the whole grid, no kernel of ours): held against
   the cell's kernel output and its plain version; cold-L2 median
   beside the kernel's, the host's against the device's microseconds per call back
   to back, and the operations per call that make the host wait for the
   card (``profiling.sync_count``).
12. sharded: the ``testing.SHARDED`` cells at the benchmark shapes on
   meshes that repeat the card, through ``get_executor(..., 'sharded')``
   with each counter reset just before its run and read just after:
   launches == shards x groups (0 for the whole-grid inner); outputs
   finite and held against ``fused_stencil_plain`` on the unsharded
   grid; blur bit-exact against the NumPy oracle; overlap 'on' (the JAX
   package's mode, here the same exchange) equal to 'off' bit for bit;
   times beside the unsharded kernel's, and host
   against device microseconds per call back to back (whether the
   host's enqueueing of the per-shard operations holds the card back),
   and the synchronising operations per call.

13. kernel modes: the ``testing.MODE_CELLS`` at the benchmark shapes
   (the streaming loop plain and peeled, the deep cp.async ring, split
   fills, staged stores; each on the short form, phase 26 holds them
   against the old mode kernel) through ``get_executor(..., **options)``,
   each counter reset just before its run and read just after: one
   launch per call; held against ``fused_stencil_plain`` over the whole
   grid (the kernel's walk in plain PyTorch, ``streamed_stencil_plain``,
   took 1-26 s a row at these shapes: the card-only tests hold each mode
   kernel to it at small shapes); blur bit-exact against the NumPy
   oracle; the cold-L2 median beside the default kernel's, the bound
   and its share, back-to-back device microseconds, CTAs and steps per CTA.
14. tools: ``tune`` on blur and jacobi3d with a cache under
   ``build/chip_smoke/`` (the winner and its time against the default
   kernel's; a second call probes nothing); ``python -m
   soda_tpu_torch.tools.gpu_validate --variants`` (every row PASS, the
   contrast float64-truth check included); ``compiled_stats`` of the blur
   and contrast kernels (registers and CTAs per SM from the card); and the
   CLI with ``--kernel-opt stream_loop=peel --kernel-opt prefetch=3``
   (jacobi3d), ``--tune``, ``--compile-stats -`` and ``--backend sharded
   --kernel-opt stream_loop=peel`` (blur), each exiting 0 with ``INFO:
   PASS!`` and at least one kernel launch.
15. layout forms: the JAX package's 24 bench seed configurations
   (``testing.SEED_CONFIGS``; 17 carry a layout key: value stages in
   registers (L1), transposed lane regions (L2)), its gate's only
   ``narrow`` row (packed 16-bit stages, L3) and chunked stage loops
   (L4) at the benchmark shapes, through ``get_executor(..., **seed)``
   (the short form, with its layout element where a key asks for one),
   each counter reset just before its run and read just after: one
   launch per call; bit for bit equal to the cell's default kernel and
   to the short form's plain version (``fused_stencil_plain``, over the
   whole grid: the same function on every valid cell, without walking
   the tiles) on the card (a seed without layout keys: within the
   threshold of it), with the largest error measured; blur
   bit-exact against the NumPy oracle; the cold-L2 median beside
   the default kernel's, bound and share, the plain version's time,
   back-to-back device microseconds, and the registers, spills and CTAs
   per SM the card reports.
16. experiments: the H100 counterparts of the JAX package's experiment
   probes (exp27, exp30: the streaming probe; exp24, exp45: the chain
   probe; built in phase 2's nvcc batch). Their entry
   points (``soda_tpu_torch.experiments.<name>.run``) with every probe
   counter reset just before and read just after: each of the 13
   streaming cases at 256^3 float32 (held against x + 1; cold-L2 ms,
   share of the byte bound, microseconds per step per CTA and back to
   back) and each of the 37 chain bodies (kernel against its plain
   version at 1, 2, 5 and CHAIN_N_SMALL iterations, microseconds per
   iteration as the slope from CHAIN_N_SMALL to CHAIN_N_BIG, grid and
   cluster barriers, the operation bound; exp24's shift chains run in
   the narrow probe's kernels, the strip kernel (roll10, proll10 and
   chunk128 a grid barrier a phase) and indep10 ``strip_cluster``, the
   chunked bodies ``chain_chunk_cluster``: one thread-block cluster
   each); each entry point is one run, so a case's
   launches are its own (the streaming cases launch the bulk kernel,
   the default). Then the streaming probe on the device alone
   (``stream_replay``): the SASS check (every bulk-kernel entry copies
   by UBLKCP and no LDGSTS, the old kernel by LDGSTS, none spills), and
   each case's default kernel and old form
   (``stream_probe(..., _old=True)``) bit for bit against
   ``stream_probe_plain`` (walking each kernel's schedule) and x + 1,
   replayed old, new, new, old beside ``torch.add`` replayed; a
   streaming record's ``ms`` and ``library_ms`` are the replayed ones.
   Each chain body against
   ``chain_probe_plain`` at 1, 2, 5 and CHAIN_N_SMALL iterations (int32
   bit-exact, float32 within ``probes.CHAIN_RTOL`` relative; the largest
   error is the record's). Then exp24's three cluster bodies beside their
   old kernels (``cluster_chain``): the SASS (the cluster barrier's
   opcodes in every cluster entry, no grid sync and no divergent branch
   there; registers and spills), each bit for bit against its plain
   version at 1, 2, 5 and CHAIN_N_SMALL iterations and against its old
   kernel (``_old=True``: the strip kernel's grid barrier a phase, PR
   6's ``chain_chunk``) at CHAIN_N_SMALL, slopes old, new, new, old,
   grid and cluster barriers, CTAs, the bound's share on the card's and
   on the cluster's SMs.
17. narrow: the 16-bit and op-rate probes (exp13, exp29, exp16, exp12,
   exp2, exp1: the narrow probe, ``csrc/probe_narrow.cu``). Each entry
   point's ``run`` with every probe counter reset just before and read
   just after: its 67 bodies on the scripts' inputs, each kernel against
   its plain version (a chain at 1, 2, 5 and the script's n_small
   iterations), a one-shot body's device µs a call replayed from a CUDA
   graph and its library call's, further its cold-L2 ms and host and
   device µs a call back to back from Python, a chain's µs per iteration
   (the slope between the script's n_small and n_big; exp2's n_big
   raised), ps per element-op,
   the bound (the least operations each body's function needs, or the
   bytes its taps read) and share, which may not exceed
   ``narrow.MAX_SHARE``, the plain version's and the library call's
   time, the SASS (registers, spills, instructions, a register chain's
   main loop); exp16's packed
   kernels equal to its wide one; exp2's copy stencil and exp1's four
   cases in both stage modes through ``get_executor`` (value bit for
   bit against vmem on the valid regions), each launched. Every body
   launched, no kernel spills, every register chain's main loop holding
   the instructions of each of its iterations (none folded). The 37
   one-shot bodies' default kernels (``vec_binary``, ``tile_fold``) beside
   their old forms (``binary``, ``fold``; ``narrow.launch(...,
   _old=True)``): registers, spills, CTAs an SM, and its key SASS ops
   (``narrow.KEY_OPS``) kept in kind: a packed op where the old form has
   one and nowhere else, each scalar one the old form has; then
   ``narrow_oneshot.run``: each body bit for bit against its plain
   version and its old form, replayed old, new, new, old and its library
   call, beside the byte bound, at the scripts' shapes and at erosion's
   bench shape (8192, 2048) with a fold's margin. Then each body's kernel
   against ``NarrowBody.plain`` again (integers bit for bit, float32
   within ``probes.CHAIN_RTOL``; the record's error); a one-shot body's
   record has its replayed ms and library ms.
18. copyshift: exp32's copy-shift probe (``csrc/probe_copy.cu``: a
   shared-memory slab copied into another at an offset by
   ``cp.async.bulk`` with ``mbarrier`` completion, as a shift; its rotate
   controls in the narrow probe's strip kernel) and exp9's 2.5-D jacobi
   (``csrc/probe_25d.cu``). Each entry point's ``run`` (exp32's main and
   check cases, exp9) with every probe counter reset just before and read
   just after: the 11 main and 8 check cases of exp32 on the script's
   blocks, each kernel bit for bit against its stale-tail plain version
   at 1, 2, 5 and 64 iterations (the check cases at 3 too), µs per
   iteration (the slope 64 -> 2048), the bound (shared-memory bytes at
   128 B a clock an SM, or operations) and its share, which may not
   exceed ``narrow.MAX_SHARE``; exp9's correctness line at (64, 16, 128)
   (bit for bit, the oracle within 1e-4), its kernel at (8192, 16, 128)
   for blocks 256, 512 and 1024 bit for bit on rows [2, h-2), and the
   port's jacobi2d kernel at block_rows 256, 512 and its default, each
   with its cold-L2 ms, share of the byte bound, back-to-back µs and the
   plain version's time (exp9's blocks run the default kernel, the
   bulk kernel). Every case launched, no kernel spills, the overlap
   kernel's chain B between its copy's issue and its wait in the SASS,
   the store control's reloads not forwarded. Then exp9 on the device
   alone (``layout25d_replay``): the SASS check (the new entry copies by
   UTMALDG alone, the old kernel's by LDGSTS alone, none spills; shared
   loads and shuffles), each block's two kernels (``jacobi25d``;
   ``_old=True``) bit for bit against ``jacobi25d_plain`` on rows [2,
   h-2), replayed old, new, new, old beside the jacobi2d default kernel
   and ``torch.add`` on the same bytes replayed (yardsticks, not the
   same function: library none); an exp9 record's ``ms`` is the new
   kernel's replayed one, held within ``narrow.MAX_SHARE`` of its
   bound.

19. deep: the many-stage form of the contrast cell's default kernel
   (``tile_plan.DeepForm``: the tile of fewest stage evaluations an
   output, thread cells fixed per extent, an interior block class,
   barriers only where a stage reads fresh data or overwrites a slot
   read since the last one, stages in shared barrier intervals), whose
   run phase 3 counted: each element step
   (``deep_steps``) bit for bit against the default form, the new kernel
   within 1e-3 of the plain version; cold-L2 medians of the old and the
   new kernel, device µs a call back to back as old, new, new, old (the
   element steps' times are ``tile_sweep --deep``'s); barriers a tile,
   resident CTAs,
   registers and spills; the bound (operations) and its share; and
   ``torch.nn.functional.conv2d`` with contrast's 17x17 table (TF32 off),
   timed as the cell's ``library_ms``.

20. short: the short form of the other 11 cells' default kernels
   (``tile_plan.ShortForm``: fixed thread cells and an interior block
   class, stages read only at offset zero kept in registers, 16-byte
   fills and whole-unit loads and stores of several cells a thread, a
   walk along axis 0 with rings of rows), whose runs phase 3 counted:
   for each cell, each element step (``tile_sweep.short_steps``) bit for
   bit against the default form (``_short=()``) and the new kernel
   within the threshold of the plain version; cold-L2 medians of the old
   and the new kernel, device µs a call back to back as old, new, new,
   old (the element steps' times are ``tile_sweep --short``'s); resident
   CTAs, registers,
   spills, stage evaluations and input cells filled an output, barriers
   a tile; the bound and its share; and, where one PyTorch call computes
   the cell's function, that call (TF32 off) with its cold-L2 median and
   largest error against the plain version, as the cell's
   ``library_ms``: a convolution with the composed table of the linear
   cells (jacobi2d, seidel2d: ``conv2d`` 5x5; jacobi3d, heat3d,
   jacobi3d_256: ``conv3d`` 5x5x5), erosion's ``-max_pool2d(-x, 19)`` on
   a float32 copy made outside the timed region.

21. graph: one dispatch per call. ``chained(ex, 100)`` over the blur,
   jacobi2d and heat3d cells (after its first call, one replay of a CUDA
   graph of the 100 calls: ``api.Chained``), the sharded calls of blur
   (4,) and heat3d (2, 2) on meshes that repeat the card (one replay of
   the exchange and per-shard launches), and fault C2's repair (a blur
   input one element into its storage): each bit for bit equal to the
   Python loop or the uncaptured call (blur also to the NumPy oracle),
   the launches a replay holds counted; device µs a step (or call) and
   host µs a call back to back, captured against uncaptured, after a
   settle run, and ``chained(ex, 10)``'s beside them (the host's time a
   call does not grow with the steps); the peak memory of the first call
   (the loop and the recording) and of a replay, in grids.
22. emit: the program ``--emit-torch`` prints for each of the 11 corpus
   cells at its bench shape, run on the card on the kernel's inputs and
   held against the kernel's outputs (integers bit-exact, floats within
   the threshold), its cold-L2 median beside the kernel's.
23. examples: ``examples/torch_image_pipeline.py``,
   ``torch_iterative_solver.py`` and ``torch_multichip_relaxation.py``
   at their default sizes on the card (kernels built in phase 2), each
   checked: the edges bit for bit against the NumPy oracle of smooth
   then edges, the solver's field and sweeps against its solve over the
   plain version on the card, the relaxation against the NumPy oracle's
   25 batches on the unsharded grid.

24. estimate: the H100 cost model (``soda_tpu_torch.model.estimate``)
   against the 12 cells' default kernels (phase 2's executors): each
   cell's device µs a call back to back (a settle run, then 200 calls
   replayed from one CUDA graph, ``profiling.replay_us``: the host
   enqueues a call in about as long as the fastest kernels run; the
   times from Python beside them) beside the estimate's ``est_time_s`` (within ``EST_RANGE`` of it), its
   share of the bound beside ``ceiling_frac`` (at most the ceiling x
   ``CEILING_SLACK``), the plan's resident CTAs beside the card's
   (``model/compiled.py``), and the estimate's form, tile and shared
   memory equal to the built executor's plan; then ``--estimate -`` of
   the command line (blur at its bench shape) and ``python -m
   soda_tpu_torch.tools.perf_report --json`` (12 rows, a geomean over 11)
   once each, with phase 25's NCCL runs (b) beside them (nothing is
   timed then).
25. ranks: the sharded executor's rank form
   (``parallel/distributed.py``, one process a shard over
   ``torch.distributed``). (a) Four gloo ranks on the card
   (``parallel/launch.py``; halos staged through host memory), and on a
   machine with four cards also four NCCL ranks, one a card, run the
   nine configs of the JAX package's ``dryrun_multichip``
   (``parallel/dryrun.py``) and the ``testing.SHARDED`` cells at the
   benchmark shapes: every output bit for bit equal to the
   single-controller form on a mesh repeating the card (on its valid
   region; everywhere under ``border: preserve``), the nine against
   the oracle (floats within 1e-4), the cells against the unsharded plain
   version (blur bit-exact against the NumPy oracle), overlap 'on' (the
   real overlapped step) equal to 'off'; each rank's launches (one a
   shard, a group's count for 'grouped'); each rank's device and host µs
   a call back to back, its kernel inner's alone (replayed from a CUDA
   graph, one rank at a time) and its halo bytes a call, beside the
   single-controller call's. (b) NCCL at
   one rank a card, through ``torchrun --standalone`` and the dry run's
   own spawn: the nine configs against the oracle, run beside phase 24's
   command-line runs. A rank that fails fails the run.
26. options: the public kernel options on the short form
   (``option_rows``: every ``testing.MODE_CELLS`` row, each short cell
   at its rule's tile and that tile's axis-0 extent halved,
   jacobi3d_256 with the JAX seeds' block_rows and mid_tile), each
   through ``get_executor(..., **keys)`` with its counter reset just
   before and read just after (one launch): bit for bit equal to the old
   kernel the same keys build with ``_short=()`` (the default form's
   kernel or mode kernel; where that kernel's buffers pass shared memory
   it never ran, and the cell's default kernel stands in), within the
   threshold of the plain version, blur bit-exact against the NumPy
   oracle; device
   µs a call back to back (replayed from a CUDA graph) as old, new, new,
   old after a settle run, then the default kernel's, the tile, elements
   off, resident CTAs, registers and spills, the bound and its share
   (40 calls a reading after a 0.1 s settle, a cell's first row after
   0.3 s: cut from 100, 0.2 and 1.0 s to make room for phases 16-17's
   cluster kernels; ``options_main`` runs the phase at both depths).
27. layout-short: the layout keys on the short form (``layout_short_rows``:
   the 19 rows of phase 15 that carry a layout key), each through
   ``get_executor(..., **keys)`` with its counter reset just before and
   read just after (one launch): bit for bit equal to the old layout
   form the same keys build with ``_short=()`` and to the cell's default
   kernel; device µs a call back to back (replayed from a CUDA graph) as
   old, new, new, old after a settle run, then the default kernel's; the
   form, tile, CTAs, the region's strip and register rows, registers,
   spills and barriers a tile. ``python -c "import chip_smoke;
   chip_smoke.layout_short_main()"`` runs this phase alone.
28. conformance: every semantics fuzz program (``testing.FUZZ_SEEDS``,
   wide and narrow), every conversion program (``testing.CAST_SEEDS``)
   and faults C5's and C6's programs at CONFORMANCE_SHAPE, each through
   ``get_executor(..., 'auto')`` (its counter reset just before and read
   just after: one launch), ``fused_stencil_plain``, ``get_executor(...,
   'xla')`` and the ``--emit-torch`` program, all on the card, held
   against the NumPy oracle on the host: integers bit-exact, floats
   within the threshold, and the conversion and fault programs equal to
   it as numbers. One line a group; ``python -c "import chip_smoke;
   chip_smoke.conformance_main()"`` runs this phase alone.

The last three lines are the card's name and power limit as nvidia-smi
prints them, a JSON object with each kernel's record (``{"kernels":
...}``: the fused kernel's per cell, mode, option and layout row, and each
probe case and body, ``probe_stream``, ``probe_chain``,
``probe_narrow``, ``probe_copy`` and ``probe_25d``, the rank form's
kernel cells, and phase 28's ``conformance`` entry with its programs),
and ``{"ok": true,
"device": ...}``. Any failure raises and exits nonzero. Inputs are made from seeded numpy (make_test_inputs).
"""

import json
import os
import re
import statistics
import subprocess
import sys
import time

FLAGSHIP = 'blur'
KERNEL_REPS = 20
PLAIN_REPS = 5
HOST_CALLS = 200
WHOLE_GRID_CALLS = 50
GROUPED = ('blur', 'sobel2d', 'denoise2d', 'heat3d')
REPLICATED = ('blur', 'jacobi2d', 'heat3d')
REPLICAS = 4
SMALL_SHAPE, SMALL_REPLICAS = (1024, 2048), 16
CLI_SHAPE = '8192,2048'
MESH_REPLICAS = (4,)
CLI_RUNS = (
    ('blur', ['--bench']),
    ('denoise2d', ['--cluster', 'coarse']),
    ('jacobi2d', ['--backend', 'replicated', '--replication-factor',
                  str(REPLICAS)]),
    ('jacobi2d', ['--backend', 'xla']),
    ('blur', ['--backend', 'sharded']),
)
# (cell, flags): the tools' command lines, at the cell's shape
TOOL_CLI_RUNS = (
    ('jacobi3d', ['--kernel-opt', 'stream_loop=peel', '--kernel-opt',
                  'prefetch=3']),
    ('blur', ['--tune']),
    ('blur', ['--compile-stats', '-']),
    ('blur', ['--backend', 'sharded', '--kernel-opt', 'stream_loop=peel']),
)
TUNED = ('blur', 'jacobi3d')
COMPILED = ('blur', 'contrast')
# the chain probes' iterations: timed from N_SMALL (checked there too,
# and at probes.CHECK_ITERS), slope to N_BIG (the scripts' 16384 would
# take minutes here)
CHAIN_N_SMALL, CHAIN_N_BIG = 64, 2048
# the many-stage form's cell (phase 19), and its back-to-back calls a
# measurement (1.6-9.7 ms a call, 0.08-0.5 s)
DEEP_CELL = 'contrast'
DEEP_CALLS = 50
# phase 20's back-to-back calls a measurement (0.03-0.5 ms a call)
SHORT_CALLS = 300
# the cells whose function one PyTorch call computes (phase 20): a linear
# stencil is one convolution with its composed table, erosion a 19x19
# max pool of the negated input; the others none, for the reason given
LINEAR = ('jacobi2d', 'seidel2d', 'jacobi3d', 'heat3d', 'jacobi3d_256')
NO_LIBRARY = {
    'blur': 'integer division', 'sobel2d': '16-bit wraps',
    'xcorr': '16-bit wraps', 'denoise2d': 'sqrt and divide over 8 stages',
    'denoise3d': 'sqrt and divide over 10 stages'}
# phase 21: the cells chained, each chain's steps and back-to-back calls
# (3-9 ms a call), the shorter chain beside it, the sharded calls
GRAPH_CELLS = ('blur', 'jacobi2d', 'heat3d')
GRAPH_STEPS, GRAPH_SHORT_STEPS, GRAPH_CALLS = 100, 10, 20
GRAPH_SHARDED = (('blur', (4,)), ('heat3d', (2, 2)))
# phase 22: cold-L2 runs of each emitted program (1-100 ms a run)
EMIT_REPS = 5
# phase 23: the port's examples (examples/torch_<name>.py)
EXAMPLES = ('image_pipeline', 'iterative_solver', 'multichip_relaxation')
# phase 25: the rank form's ranks on the card (gloo)
RANKS = 4
# phase 26: each row's back-to-back calls a measurement, replayed from a
# CUDA graph (0.03-0.4 ms a call: enqueued from Python, the fastest read
# the host's time), its settle run's seconds, and jacobi3d_256 with the
# JAX seeds' block_rows and mid_tile (phase 27 runs at OPTION_CALLS and
# OPTION_SETTLE_S; phase 26 at the last of OPTION26_DEPTHS, each (calls a
# reading, the new form's settle s, a cell's first settle s): cut from
# the first to make room for phases 16-17's cluster kernels, and
# ``options_main`` runs the phase at both)
OPTION_CALLS = 100
OPTION_SETTLE_S = 0.2
OPTION26_DEPTHS = ((100, 0.2, 1.0), (40, 0.1, 0.3))
OPTION_FIXED = (('jacobi3d_256', {'block_rows': 16}),
                ('jacobi3d_256', {'mid_tile': 64}))
# phase 28: the conformance programs' shape (several short-form tiles,
# ragged on both axes) and the cold-L2 calls timed of each kernel and
# plain version
CONFORMANCE_SHAPE = (200, 600)
CONFORMANCE_REPS = 5
# phase 24: the estimate's time against the measured one, and the slack a
# measured share may take over the model's ceiling
EST_RANGE = (0.67, 1.5)
CEILING_SLACK = 1.03
# the keys --estimate prints (the JAX package's, but for its TPU-only ones)
ESTIMATE_KEYS = (
    'device', 'peak_hbm_gbps', 'peak_gops', 'cells', 'hbm_bytes',
    'arithmetic_intensity', 'ops_per_cell', 'bound', 'op_model',
    'model_roofline_frac', 'ceiling_frac', 'ideal_time_s',
    'ideal_cells_per_s', 'ideal_effective_gbps', 'est_time_s',
    'est_roofline_frac', 'halo', 'stages', 'total_reuse_distance', 'form',
    'tile', 'smem_bytes', 'smem_ok', 'ctas_per_sm', 'tiles', 'waves',
    'evaluations_per_output', 'fills_per_output', 'barriers_per_tile',
    'launches')


def say(*parts):
  print(*parts, flush=True)


def deep_steps():
  """(label, elements) of the many-stage form's measurement: the
  default form, then tile_plan.DEEP_ELEMENTS turned on one by one."""
  from soda_tpu_torch.backend.tile_plan import DEEP_ELEMENTS
  return [('default form', ())] + [
      ('+' + e, DEEP_ELEMENTS[:i + 1]) for i, e in enumerate(DEEP_ELEMENTS)]


def deep_sources(stencil, shape):
  """The kernel sources of ``deep_steps`` at ``shape``."""
  from soda_tpu_torch.backend import cuda_source
  from soda_tpu_torch.backend.tile_plan import make_tile_plan
  return [cuda_source.generate(make_tile_plan(stencil, shape, _deep=elements))
          for _, elements in deep_steps()]


def deep_phase(stencil, shape, ex, plain, plain_ms, smi, log):
  """Phase 19: the many-stage form (tile_plan.DeepForm) of the contrast
  cell, whose default kernel ``ex`` the main path ran. Each element step
  of ``deep_steps`` bit for bit against the default form (the old
  kernel) and the new kernel within the threshold of the plain version
  ``plain`` (phase 4's); cold-L2 medians of the old and the new kernel,
  device µs a call back to back as old, new, new, old (each element
  step is checked, not timed: ``tile_sweep --deep`` times them); barriers
  a tile,
  resident CTAs, registers and spills; the bound and its share; and
  ``torch.nn.functional.conv2d`` with contrast's 17x17 table over the
  valid region (TF32 off; the port never calls it): its cold-L2 median
  and largest error against the plain version. Returns the conv2d
  median in ms."""
  import torch
  from soda_tpu_torch import corpus, profiling, testing
  from soda_tpu_torch.backend.fused import FusedExecutor
  from soda_tpu_torch.backend.tile_plan import stage_evaluations
  from soda_tpu_torch.model.compiled import compiled_stats
  inputs = testing.make_test_inputs(stencil, shape)
  params = testing.make_test_params(stencil)
  args = ex.prepare(inputs, params)
  steps = [(label, FusedExecutor(stencil, shape, _deep=elements))
           for label, elements in deep_steps()]
  old = steps[0][1]
  want = dict(zip(stencil.output_names, old.fn(*args)))
  for label, step in steps[1:] + [('default kernel', ex)]:
    got = dict(zip(stencil.output_names, step.fn(*args)))
    testing.check_exact(stencil, shape, got, want, 'contrast %s vs the '
                        'default form' % label)
  new_out = dict(zip(stencil.output_names, ex.fn(*args)))
  err = testing.check_outputs(stencil, shape, new_out, plain,
                              'contrast new form vs plain')
  del got, new_out
  torch.cuda.synchronize()
  for label, step in steps + [('default kernel', ex)]:
    card = compiled_stats(step)['kernels'][0]
    deep = step.plan.deep
    log('%-14s tile %-9s %6d B smem, %d CTA(s)/SM (card %d), %3d barriers '
        'a tile, %.1f evaluations/output, %d registers, spills %d/%d B, == '
        'default form bit for bit' % (
            label, step.plan.tile, step.plan.smem_bytes,
            deep.ctas if deep else 1, card['ctas_per_sm'],
            len(deep.barriers) if deep else len(step.plan.stages),
            stage_evaluations(step.plan.spans, step.plan.tile,
                              step.plan.stages), card['registers'],
            card['spill_stores'], card['spill_loads']))
    if card['spill_stores'] or card['spill_loads']:
      raise RuntimeError('contrast %s spills' % label)

  def b2b(e):
    return profiling.back_to_back_us(lambda: e.fn(*args), calls=DEEP_CALLS)[1]

  old_ms = statistics.median(profiling.cuda_times_ms(lambda: old.fn(*args),
                                                     reps=KERNEL_REPS))
  new_ms = statistics.median(profiling.cuda_times_ms(lambda: ex.fn(*args),
                                                     reps=KERNEL_REPS))
  seq = [b2b(old), b2b(ex), b2b(ex), b2b(old)]
  bound, bound_by = profiling.bound_ms(stencil, shape)
  log('old form %.4f ms cold, new %.4f ms (%.3fx); back to back old, new, '
      'new, old %.1f/%.1f/%.1f/%.1f us/call (new/old %.3f); bound %.4f ms '
      '(%s), share old %.2f%%, new %.2f%%; plain %.1f ms; new vs plain max '
      '|err| %.3g | %s' % (
          old_ms, new_ms, new_ms / old_ms, seq[0], seq[1], seq[2], seq[3],
          (seq[1] + seq[2]) / (seq[0] + seq[3]), bound, bound_by,
          100 * bound / old_ms, 100 * bound / new_ms, plain_ms, err, smi))
  torch.backends.cudnn.allow_tf32 = False
  x = args[0].reshape((1, 1) + shape)
  w = torch.from_numpy(corpus.contrast_table()).to(x.device)[None, None]
  conv = torch.nn.functional.conv2d(x, w)[0, 0]
  region = testing.output_valid_slices(stencil, shape, 'output')
  lib_err = float((conv - plain['output'][region]).abs().max())
  lib_ms = statistics.median(profiling.cuda_times_ms(
      lambda: torch.nn.functional.conv2d(x, w), reps=KERNEL_REPS))
  log('library: conv2d with the 17x17 table (TF32 off) %.4f ms cold, max '
      '|err| %.3g against the plain version, %.2fx the new form\'s time | %s'
      % (lib_ms, lib_err, lib_ms / new_ms, smi))
  return lib_ms


def short_cells():
  """The benchmark cells whose default kernel is the short form."""
  from soda_tpu_torch import testing
  return [c for c in testing.CELLS if c[0] != DEEP_CELL]


def short_sources(stencils):
  """The kernel sources of each short cell's element steps."""
  from soda_tpu_torch.backend import cuda_source
  from soda_tpu_torch.backend.tile_plan import make_tile_plan
  from soda_tpu_torch.tile_sweep import short_steps
  return [cuda_source.generate(make_tile_plan(stencils[name], shape,
                                              _short=elements))
          for name, shape, _ in short_cells()
          for _, elements in short_steps(len(shape))]


def composed_table(stencil, dim):
  """The table of a linear stencil's whole function: the plain version's
  response to a unit impulse, flipped, on the CPU."""
  import torch
  from soda_tpu_torch import testing
  from soda_tpu_torch.backend.fused import fused_stencil_plain
  out = stencil.output_names[0]
  probe = tuple(64 for _ in range(dim))
  region = testing.output_valid_slices(stencil, probe, out)
  lo = [r.start for r in region]
  hi = [p - r.stop for p, r in zip(probe, region)]
  size = tuple(2 * (a + b) + 1 for a, b in zip(lo, hi))
  x = torch.zeros(size, dtype=torch.float32)
  x[tuple(a + b for a, b in zip(lo, hi))] = 1
  y = fused_stencil_plain(stencil, [x])[0]
  y = y[testing.output_valid_slices(stencil, size, out)]
  return torch.flip(y, tuple(range(dim)))


def library_call(name, stencil, shape, x):
  """(fn, region) of the one PyTorch call that computes cell ``name``'s
  function on input ``x`` (``fn()`` gives the output's valid region; an
  ``x`` with a leading replica axis, each replica's, as one batched
  call), or None (NO_LIBRARY says why)."""
  import torch
  from soda_tpu_torch import testing
  region = testing.output_valid_slices(stencil, shape,
                                       stencil.output_names[0])
  pick = (slice(None), 0) if x.dim() > len(shape) else (0, 0)
  if name in LINEAR:
    w = composed_table(stencil, len(shape)).to(x.device)[None, None]
    conv = (torch.nn.functional.conv2d if len(shape) == 2 else
            torch.nn.functional.conv3d)
    xb = x.reshape((-1, 1) + tuple(shape))
    return (lambda: conv(xb, w)[pick]), region
  if name == 'erosion':
    xf = x.float().reshape((-1, 1) + tuple(shape))
    return (lambda: -torch.nn.functional.max_pool2d(-xf, 19, stride=1)[pick]
            ), region
  return None


def short_phase(cells, plains, smi, log):
  """Phase 20: the short form (tile_plan.ShortForm) of the 11 cells other
  than contrast, whose default kernels the main path ran (``cells``:
  phase 2's tuples). Per cell, each element step of
  ``tile_sweep.short_steps`` bit for bit against the default form (the
  old kernel) and the new kernel within the threshold of the plain
  version ``plains[name]`` (phase 4's); cold-L2 medians of the old and
  the new kernel, device µs a call back to back as old, new, new, old
  (each element step is checked, not timed: ``tile_sweep --short`` times
  them); resident
  CTAs, registers and spills, stage evaluations and input cells filled
  an output, barriers a tile; the bound and its share; and the library
  call (``library_call``, TF32 off; the port never calls it) with its
  cold-L2 median and largest error against the plain version. Returns
  cell -> library ms (None where no call computes the function)."""
  import torch
  from soda_tpu_torch import profiling, testing
  from soda_tpu_torch.backend.fused import FusedExecutor
  from soda_tpu_torch.model.compiled import compiled_stats
  from soda_tpu_torch.tile_sweep import short_steps
  torch.backends.cudnn.allow_tf32 = False
  torch.backends.cuda.matmul.allow_tf32 = False
  lib = {}
  for name, shape, stencil, ex, inputs, params in cells:
    if name == DEEP_CELL:
      continue
    t = time.time()
    args = ex.prepare(inputs, params)
    steps = [(label, FusedExecutor(stencil, shape, _short=elements))
             for label, elements in short_steps(len(shape))]
    old = steps[0][1]
    want = dict(zip(stencil.output_names, old.fn(*args)))
    for label, step in steps[1:] + [('default kernel', ex)]:
      got = dict(zip(stencil.output_names, step.fn(*args)))
      testing.check_exact(stencil, shape, got, want, '%s %s vs the default '
                          'form' % (name, label))
    new_out = dict(zip(stencil.output_names, ex.fn(*args)))
    err = testing.check_outputs(stencil, shape, new_out, plains[name],
                                '%s new form vs plain' % name)
    del got, new_out
    torch.cuda.synchronize()
    for label, step in steps + [('default kernel', ex)]:
      card = compiled_stats(step)['kernels'][0]
      short = step.plan.short
      log('%-12s %-34s tile %-14s %6d B smem, %d CTA(s)/SM (card %d), %s, '
          '%s, %d registers, spills %d/%d B%s' % (
              name, label, step.plan.tile, step.plan.smem_bytes,
              short.ctas if short else 0, card['ctas_per_sm'],
              'elements on: %s, %d barriers a tile, %.2f evaluations and '
              '%.2f fills/output, %d cell(s) a thread, %d step(s) a CTA' % (
                  '+'.join(short.on), len(short.barriers), short.evaluations,
                  short.fills, short.vec, step.plan.steps) if short else
              '%d barriers a tile' % len(step.plan.stages),
              'registers: %s' % (', '.join(short.values) or 'none')
              if short else 'every stage buffered', card['registers'],
              card['spill_stores'], card['spill_loads'],
              '' if step is old else ', == default form bit for bit'))

    def b2b(e):
      return profiling.back_to_back_us(lambda: e.fn(*args),
                                       calls=SHORT_CALLS)[1]

    profiling.settle(lambda: ex.fn(*args))
    old_ms = statistics.median(profiling.cuda_times_ms(
        lambda: old.fn(*args), reps=KERNEL_REPS))
    new_ms = statistics.median(profiling.cuda_times_ms(
        lambda: ex.fn(*args), reps=KERNEL_REPS))
    seq = [b2b(old), b2b(ex), b2b(ex), b2b(old)]
    bound, bound_by = profiling.bound_ms(stencil, shape)
    log('%-12s old form %.4f ms cold, new %.4f ms (%.3fx); back to back old, '
        'new, new, old %.1f/%.1f/%.1f/%.1f us/call (new/old %.3f); bound '
        '%.4f ms (%s), share old %.1f%%, new %.1f%%; new vs plain max |err| '
        '%.3g | %s' % (
            name, old_ms, new_ms, new_ms / old_ms, seq[0], seq[1], seq[2],
            seq[3], (seq[1] + seq[2]) / (seq[0] + seq[3]), bound, bound_by,
            100 * bound / old_ms, 100 * bound / new_ms, err, smi))
    call = library_call(name, stencil, shape, args[0])
    if call is None:
      lib[name] = None
      log('%-12s library: none (%s)' % (name, NO_LIBRARY[name]))
    else:
      fn, region = call
      got = fn()
      out = stencil.output_names[0]
      lib_err = float((got.double() - plains[name][out][region].double()
                       ).abs().max())
      lib[name] = statistics.median(profiling.cuda_times_ms(
          fn, reps=KERNEL_REPS))
      log('%-12s library: %s %.4f ms cold, max |err| %.3g against the plain '
          'version, %.2fx the new form\'s time | %s' % (
              name, 'conv%dd with the composed table (TF32 off)' % len(
                  shape) if name in LINEAR else '-max_pool2d(-x, 19) on a '
              'float32 copy', lib[name], lib_err, lib[name] / new_ms, smi))
    del steps, old, want
    torch.cuda.synchronize()
    log('%-12s (%.1fs)' % (name, time.time() - t))
  return lib


def option_rows(stencils):
  """(cell, keys) of phase 26: every ``testing.MODE_CELLS`` row; for each
  short cell, ``tile=`` its rule's tile and that tile's axis-0 extent
  halved (jacobi3d_256, whose rule takes 1: its axis-1 extent);
  ``OPTION_FIXED``."""
  from soda_tpu_torch import testing
  from soda_tpu_torch.backend.tile_plan import make_tile_plan
  rows = list(testing.MODE_CELLS)
  for name, shape, _ in short_cells():
    t = make_tile_plan(stencils[name], shape).tile
    half = (t[0] // 2,) + t[1:] if t[0] > 1 else (1, t[1] // 2) + t[2:]
    rows += [(name, {'tile': tile}) for tile in (t, half)]
  return rows + list(OPTION_FIXED)


def option_sources(stencils, shape_of):
  """The kernel sources of phase 26: each row's short form and its old
  kernel (``_short=()``, the same keys) where that fits shared memory
  (the old form took an explicit tile past it, and failed at launch)."""
  from soda_tpu_torch.backend import cuda_source
  from soda_tpu_torch.backend.tile_plan import SMEM_LIMIT, kernel_plan
  plans = [kernel_plan(stencils[name], shape_of[name], **keys, **old)
           for name, keys in option_rows(stencils)
           for old in ({}, {'_short': ()})]
  return [cuda_source.generate(p) for p in plans
          if p.smem_bytes <= SMEM_LIMIT]


def option_label(keys):
  return ' '.join('%s=%s' % (k, ','.join(map(str, v)) if k == 'tile' else v)
                  for k, v in sorted(keys.items()))


def options_phase(cells, plains, plain_ms_of, lib, check_oracle, smi, log,
                  depth=OPTION26_DEPTHS[-1], ratios=None):
  """Phase 26: the public kernel options on the short form. Each row of
  ``option_rows`` through ``get_executor(..., **keys)``, its counter
  reset just before the user's call and read just after (one launch):
  bit for bit equal to the old kernel the same keys build with
  ``_short=()`` on the valid regions (where that kernel's buffers pass
  shared memory, so that it never launched: to the cell's default
  kernel, ``cells``: phase 2's executors), within the threshold of the
  plain version ``plains[name]`` (phase 4's), blur bit-exact against
  the NumPy oracle; after a settle run, device µs a call back to back
  (``profiling.replay_us``) as old, new, new, old, then the default
  kernel's; the tile, the elements off, resident CTAs (the plan's and
  the card's), registers and spills. ``depth``: calls a reading, the
  new form's settle seconds, a cell's first settle seconds; ``ratios``, a
  dict, receives each row's new/old (or new/default) ratio by its label.
  Returns the rows' kernel records (``library_ms``: the cell's,
  ``lib``)."""
  import torch
  import soda_tpu_torch
  from soda_tpu_torch import profiling, testing
  from soda_tpu_torch.backend import cuda_source
  from soda_tpu_torch.backend.fused import FusedExecutor
  from soda_tpu_torch.backend.tile_plan import SMEM_LIMIT, kernel_plan
  from soda_tpu_torch.model.compiled import compiled_stats
  by_name = {c[0]: c for c in cells}
  stencils = {c[0]: c[2] for c in cells}
  calls, settle_s, first_s = depth
  settled = set()
  records = []
  for name, keys in option_rows(stencils):
    _, shape, stencil, default, inputs, params = by_name[name]
    t = time.time()
    label = '%s %s' % (name, option_label(keys))
    new = soda_tpu_torch.get_executor(stencil, shape, **keys)
    old_bytes = kernel_plan(stencil, shape, **keys, _short=()).smem_bytes
    old = (FusedExecutor(stencil, shape, **keys, _short=())
           if old_bytes <= SMEM_LIMIT else default)
    if not isinstance(new, FusedExecutor) or new.plan.short is None or (
        old is not default and old.plan.short is not None):
      raise RuntimeError('%s: not the short form against the old kernel'
                         % label)
    against = ('old kernel' if old is not default else 'default kernel (the '
               'old kernel needs %d B of shared memory: it never ran)' %
               old_bytes)
    new.launches = 0
    got = new(inputs, params)
    torch.cuda.synchronize()
    launches = new.launches
    if launches != 1:
      raise RuntimeError('%s: %d launches for one call' % (label, launches))
    args = new.prepare(inputs, params)
    testing.check_exact(stencil, shape, got, dict(zip(
        stencil.output_names, old.fn(*args))), '%s vs the %s' % (
            label, against))
    err = testing.check_outputs(stencil, shape, got, plains[name],
                                label + ' vs plain')
    exact = ''
    if name == FLAGSHIP:
      check_oracle(got, label)
      exact = ', bit-exact vs the NumPy oracle'
    del got
    card = compiled_stats(new)['kernels'][0]

    def b2b(e):
      return profiling.replay_us(lambda: e.fn(*args), calls=calls)

    if name not in settled:  # a cell's first row: warm the clocks
      profiling.settle(lambda: default.fn(*args), first_s)
      settled.add(name)
    profiling.settle(lambda: new.fn(*args), settle_s)
    seq = [b2b(old), b2b(new), b2b(new), b2b(old)]
    default_us = b2b(default)
    ratio = (seq[1] + seq[2]) / (seq[0] + seq[3])
    if ratios is not None:
      ratios[label] = ratio
    new_us = (seq[1] + seq[2]) / 2
    lead = next((k for k in ('prefetch', 'dma_split', 'out_dma',
                             'stream_loop') if k in keys), None)
    replaces = (cuda_source.MODE_REPLACES[lead] if lead else
                'soda_tpu/backend/pallas_kernel.py:1605' if 'mid_tile' in keys
                else cuda_source.REPLACES)
    records.append(record('fused_stencil_option[%s]' % label,
                          'soda_tpu_torch/backend/cuda_source.py', replaces,
                          launches, err, new_us / 1e3, plain_ms_of[name],
                          stencil, shape))
    records[-1]['library_ms'] = lib.get(name)
    plan, short = new.plan, new.plan.short
    bound = records[-1]['bound_ms']
    log('%-40s tile %s, %d CTAs x %d steps, depth %d, elements on: %s%s, '
        '%d B smem, %d CTA(s)/SM (card %d), %d registers, spills %d/%d B: 1 '
        'launch, == %s bit for bit, == plain (max |err| %.3g)%s; back to '
        'back %s, new, new, %s %.1f/%.1f/%.1f/%.1f us/call (new/%s %.3f), '
        'default kernel %.1f us (new/default %.3f); bound %.4f ms, share new '
        '%.1f%% (%.1fs) | %s' % (
            label, plan.tile, plan.n_ctas, plan.steps, short.depth,
            '+'.join(short.on),
            ' (off: %s)' % ', '.join(sorted(short.off)) if short.off else '',
            plan.smem_bytes, short.ctas, card['ctas_per_sm'],
            card['registers'], card['spill_stores'], card['spill_loads'],
            against, err, exact, *(('old',) * 2 if old is not default else
                                   ('default',) * 2),
            seq[0], seq[1], seq[2], seq[3],
            'old' if old is not default else 'default', ratio, default_us,
            new_us / default_us, bound, 100 * bound / (new_us / 1e3),
            time.time() - t, smi))
    del new, old, args
  torch.cuda.empty_cache()
  return records


def example_modules(here):
  """The port's three examples, loaded (not run): name -> globals."""
  import runpy
  return {name: runpy.run_path(os.path.join(here, 'examples',
                                            'torch_%s.py' % name))
          for name in EXAMPLES}


def example_sources(examples, card):
  """The kernel sources the examples run at their default sizes (phase
  23): smooth and edges, the solver's jacobi, the relaxation's jacobi
  per halo-extended shard of its (4,) mesh."""
  from soda_tpu_torch import build_stencil, testing
  from soda_tpu_torch.backend import cuda_source
  from soda_tpu_torch.backend.tile_plan import make_tile_plan
  from soda_tpu_torch.parallel import spmd
  image = examples['image_pipeline']
  solver = examples['iterative_solver']
  relax = examples['multichip_relaxation']
  plans = [make_tile_plan(build_stencil(image[key], tile_size=(
      image['SHAPE'][1], 0)), image['SHAPE']) for key in ('SMOOTH', 'EDGES')]
  plans.append(make_tile_plan(build_stencil(solver['JACOBI'], tile_size=(
      solver['SHAPE'][1], 0)), solver['SHAPE']))
  stencil = build_stencil(relax['JACOBI4'], tile_size=(relax['SHAPE'][1], 0))
  plans.append(make_tile_plan(stencil, spmd.geometry(
      stencil, relax['SHAPE'],
      testing.repeated_mesh(card, (relax['MESH'],)))[-1]))
  return [cuda_source.generate(plan) for plan in plans]


def graph_phase(by_name, oracle, card, smi, log):
  """Phase 21: one dispatch per call. ``chained(ex, 100)`` over the
  blur, jacobi2d and heat3d cells, the sharded calls of blur (4,) and
  heat3d (2, 2) on meshes that repeat the card, and fault C2's
  misaligned blur call. Each replay bit for bit equal to the Python loop
  or the uncaptured call (blur also to the NumPy oracle); launches a
  replay; host and device µs a call back to back, captured against
  uncaptured, after a settle run; peak memory of the first call (the
  loop and the recording) and of a replay, in grids."""
  import torch
  import soda_tpu_torch
  from soda_tpu_torch import profiling, testing
  from soda_tpu_torch.backend import tile_plan

  def back_to_back(fn, calls):
    profiling.settle(fn)
    return profiling.back_to_back_us(fn, calls=calls)

  def peak(fn):
    """(fn(), bytes its call allocated at most beyond what was held)."""
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated() - held

  def named(stencil, outs):
    return dict(zip(stencil.output_names, outs))

  def check_oracle(got, context):
    _, shape, stencil, _, _, _ = by_name[FLAGSHIP]
    testing.check_outputs(stencil, shape, got, oracle, context + ' vs oracle')

  for name in GRAPH_CELLS:
    t = time.time()
    _, shape, stencil, ex, inputs, params = by_name[name]
    args = ex.prepare(inputs, params)
    grid = args[0].numel() * args[0].element_size()
    run = soda_tpu_torch.chained(ex, GRAPH_STEPS)
    want = named(stencil, run.loop(*args))
    first, first_peak = peak(lambda: run(*args))
    ex.launches = 0
    got, replay_peak = peak(lambda: run(*args))
    launches = ex.launches
    if launches != GRAPH_STEPS or run.replays != 1:
      raise RuntimeError('%s: a replay of chained(ex, %d) counted %d '
                         'launches (%d replays)' % (
                             name, GRAPH_STEPS, launches, run.replays))
    testing.check_exact(stencil, shape, named(stencil, first), want,
                        name + ' chained: first call vs loop')
    testing.check_exact(stencil, shape, named(stencil, got), want,
                        name + ' chained: replay vs loop')
    del first, got, want
    short = soda_tpu_torch.chained(ex, GRAPH_SHORT_STEPS)
    short(*args)
    host_s, dev_s = back_to_back(lambda: short(*args), GRAPH_CALLS)
    host_c, dev_c = back_to_back(lambda: run(*args), GRAPH_CALLS)
    host_l, dev_l = back_to_back(lambda: run.loop(*args), GRAPH_CALLS)
    log('%-9s chained(ex, %d) %s: replay == loop bit for bit, %d launches '
        'a replay; device %.2f us a step captured, %.2f uncaptured '
        '(%.3fx); host %.1f us a call captured, %.1f uncaptured; '
        'chained(ex, %d) captured: host %.1f us, device %.2f us a step; '
        'peak memory first call %.2f grids, replay %.2f (grid %.1f MiB) '
        '(%.1fs) | %s' % (
            name, GRAPH_STEPS, shape, launches, dev_c / GRAPH_STEPS,
            dev_l / GRAPH_STEPS, dev_c / dev_l, host_c, host_l,
            GRAPH_SHORT_STEPS, host_s, dev_s / GRAPH_SHORT_STEPS,
            first_peak / grid, replay_peak / grid, grid / 2 ** 20,
            time.time() - t, smi))
    del args, run, short
    torch.cuda.empty_cache()

  for name, mesh_shape in GRAPH_SHARDED:
    t = time.time()
    _, shape, stencil, _, inputs, params = by_name[name]
    ex = soda_tpu_torch.get_executor(
        stencil, shape, 'sharded', mesh=testing.repeated_mesh(card,
                                                              mesh_shape))
    args = ex.prepare(inputs, params)
    grid = sum(t_.numel() * t_.element_size() for t_ in args[0].tensors.flat)
    crop = tuple(slice(0, r) for r in shape)

    def gathered(outs):
      return {n: o.gather()[crop] for n, o in zip(stencil.output_names, outs)}

    want = gathered(ex.fn_eager(*args))
    first, first_peak = peak(lambda: ex.fn(*args))
    ex.launches = 0
    got, replay_peak = peak(lambda: ex.fn(*args))
    launches = ex.launches
    if launches != ex.n_shards or ex.replays != 1:
      raise RuntimeError('%s %s: a sharded replay counted %d launches for '
                         '%d shards (%d replays)' % (
                             name, mesh_shape, launches, ex.n_shards,
                             ex.replays))
    label = '%s %s sharded' % (name, mesh_shape)
    testing.check_exact(stencil, shape, gathered(first), want,
                        label + ': first call vs uncaptured')
    testing.check_exact(stencil, shape, gathered(got), want,
                        label + ': replay vs uncaptured')
    exact = ''
    if name == FLAGSHIP:
      check_oracle(gathered(got), label + ' replay')
      exact = ', bit-exact vs the NumPy oracle'
    del first, got, want
    host_c, dev_c = back_to_back(lambda: ex.fn(*args), HOST_CALLS)
    host_e, dev_e = back_to_back(lambda: ex.fn_eager(*args), HOST_CALLS)
    log('%-9s sharded %s %s: replay == uncaptured bit for bit%s, %d '
        'launches a replay; device %.1f us a call captured, %.1f '
        'uncaptured (%.3fx); host %.1f us captured, %.1f uncaptured; peak '
        'memory first call %.2f grids, replay %.2f (%.1fs) | %s' % (
            name, mesh_shape, shape, exact, launches, dev_c, dev_e,
            dev_c / dev_e, host_c, host_e, first_peak / grid,
            replay_peak / grid, time.time() - t, smi))
    del args, ex
    torch.cuda.empty_cache()

  # fault C2: an input one element into its storage
  t = time.time()
  _, shape, stencil, ex, inputs, params = by_name[FLAGSHIP]
  (aligned,) = ex.prepare(inputs, params)
  storage = torch.empty(aligned.numel() + 1, dtype=aligned.dtype,
                        device=aligned.device)
  x = storage[1:].view(shape)
  x.copy_(aligned)
  if not x.data_ptr() % tile_plan.VECTOR_BYTES:
    raise RuntimeError('the C2 input is aligned')
  ex.launches = 0
  got = named(stencil, ex.fn(x))
  torch.cuda.synchronize()
  if ex.launches != 1:
    raise RuntimeError('C2: %d launches' % ex.launches)
  check_oracle(got, 'blur misaligned (C2)')
  host_m, dev_m = back_to_back(lambda: ex.fn(x), HOST_CALLS)
  host_a, dev_a = back_to_back(lambda: ex.fn(aligned), HOST_CALLS)
  log('C2 blur %s, input at +2 B: bit-exact vs the NumPy oracle, 1 launch; '
      'device %.1f us a call misaligned, %.1f aligned; host %.1f, %.1f '
      '(%.1fs) | %s' % (shape, dev_m, dev_a, host_m, host_a,
                        time.time() - t, smi))


def emit_phase(cells, results, kernel_ms, smi, log):
  """Phase 22: the program ``--emit-torch`` prints for each of the 11
  corpus cells at its bench shape, run on the card on the kernel's
  inputs and held against the kernel's outputs (phase 3) on the valid
  regions: integers bit-exact, floats within the threshold; its cold-L2
  median beside the kernel's."""
  import types
  import torch
  from soda_tpu_torch import corpus, profiling, testing
  from soda_tpu_torch.codegen import torch_source
  for name, shape, stencil, ex, inputs, params in cells:
    if name not in corpus.CORPUS:
      continue
    t = time.time()
    module = types.ModuleType('emitted_' + name)
    exec(compile(torch_source.generate(stencil, shape), '<%s>' % name,
                 'exec'), module.__dict__)
    args = ex.prepare(inputs, params)
    got = module.compute(*args)
    torch.cuda.synchronize()
    err = testing.check_outputs(stencil, shape, got, results[name],
                                name + ' emitted vs kernel')
    del got
    ms = statistics.median(profiling.cuda_times_ms(
        lambda: module.compute(*args), reps=EMIT_REPS, warmup=1))
    log('%-12s %-16s emitted torch program == kernel (max |err| %.3g)  '
        '%.3f ms (n=%d) against the kernel\'s %.4f ms (%.0fx) (%.1fs) | %s'
        % (name, shape, err, ms, EMIT_REPS, kernel_ms[name],
           ms / kernel_ms[name], time.time() - t, smi))
    del args, module
    torch.cuda.empty_cache()


def examples_phase(examples, card, smi, log):
  """Phase 23: the three examples at their default sizes on the card,
  each checked: the image pipeline's edges bit for bit against the
  NumPy oracle of smooth then edges; the solver's field and sweep count
  against its own solve over the whole-grid executor (the plain version
  on the card); the relaxation against the NumPy oracle's 25 batches on
  the unsharded grid."""
  import contextlib
  import io
  import numpy as np
  import torch
  from soda_tpu_torch import build_stencil, testing
  from soda_tpu_torch.backend.whole_grid import WholeGridExecutor

  def run(name):
    out = io.StringIO()
    t = time.time()
    with contextlib.redirect_stdout(out):
      result = examples[name]['main'](['--device', card.type])
    torch.cuda.synchronize()
    for line in out.getvalue().strip().splitlines():
      log('%s: %s' % (name, line))
    return result, time.time() - t

  image = examples['image_pipeline']
  mag, seconds = run('image_pipeline')
  shape = image['SHAPE']
  smooth = build_stencil(image['SMOOTH'], tile_size=(shape[1], 0))
  edges = build_stencil(image['EDGES'], tile_size=(shape[1], 0))
  s = testing.oracle_run(smooth, {'img': image['make_image'](shape)})['s']
  want = testing.oracle_run(edges, {'s': s})['mag']
  if not np.array_equal(mag[4:-4, 4:-4], want[4:-4, 4:-4]):
    raise RuntimeError('image_pipeline: edges differ from the NumPy oracle')
  log('image_pipeline %s: edges bit-exact vs the NumPy oracle of smooth '
      'then edges (%.1fs) | %s' % (shape, seconds, smi))

  solver = examples['iterative_solver']
  (u, residual, sweeps), seconds = run('iterative_solver')
  shape = solver['SHAPE']
  stencil = build_stencil(solver['JACOBI'], tile_size=(shape[1], 0))
  u0 = torch.zeros(shape, dtype=torch.float32, device=card)
  u0[:, 0] = 1.0
  plain_u, plain_residual, plain_sweeps = solver['solve'](
      WholeGridExecutor(stencil, shape, device=card), u0, solver['BATCH'])
  if sweeps != plain_sweeps:
    raise RuntimeError('iterative_solver: %d sweeps, the plain version %d'
                       % (sweeps, plain_sweeps))
  err = testing.check_outputs(stencil, shape, {'un': u}, {'un': plain_u},
                              'iterative_solver vs plain', full=True)
  log('iterative_solver %s: %d sweeps, residual %.3g, == its solve over the '
      'plain version (%d sweeps, max |err| %.3g) (%.1fs) | %s' % (
          shape, sweeps, residual, plain_sweeps, err, seconds, smi))

  relax = examples['multichip_relaxation']
  u_final, seconds = run('multichip_relaxation')
  shape = relax['SHAPE']
  stencil = build_stencil(relax['JACOBI4'], tile_size=(shape[1], 0))
  u = np.zeros(shape, np.float32)
  u[:, :4] = 1.0
  for _ in range(relax['BATCHES']):
    u = testing.oracle_run(stencil, {'u': u})['un']
  err = testing.check_outputs(stencil, shape, {'un': u_final}, {'un': u},
                              'multichip_relaxation vs oracle', full=True)
  log('multichip_relaxation %s x %d batches on a (%d,) mesh of the card: '
      '== the NumPy oracle on the whole grid (max |err| %.3g) (%.1fs) | %s'
      % (shape, relax['BATCHES'], relax['MESH'], err, seconds, smi))


def estimate_phase(cells, here, env, smi, log, log_ranks):
  """Phase 24: the cost model against the default kernels phase 2 built
  (``cells``), then the command line's --estimate and perf_report once
  each, with phase 25's NCCL runs (b) beside them (``nccl_start``; their
  lines go to ``log_ranks``): nothing is timed while they run. Raises
  where an estimate's plan differs from the built one, a measured share
  exceeds the ceiling x CEILING_SLACK, an estimate lies outside
  EST_RANGE of the measured time, or a run fails."""
  import torch
  from soda_tpu_torch import profiling
  from soda_tpu_torch.model import estimate as est
  from soda_tpu_torch.model.compiled import compiled_stats
  bad = []
  for name, shape, stencil, ex, inputs, params in cells:
    t = time.time()
    e = est.estimate(stencil, shape, 'cuda')
    args = ex.prepare(inputs, params)
    profiling.settle(lambda: ex.fn(*args))
    us = profiling.replay_us(lambda: ex.fn(*args), calls=HOST_CALLS)
    host_us, python_us = profiling.back_to_back_us(lambda: ex.fn(*args),
                                                   calls=HOST_CALLS)
    share = e['ideal_time_s'] * 1e6 / us
    ratio = e['est_time_s'] * 1e6 / us
    card_ctas = compiled_stats(ex)['kernels'][0]['ctas_per_sm']
    plan = ex.plan
    same = (e['form'], tuple(e['tile']), e['smem_bytes']) == (
        est.form(plan), plan.tile, plan.smem_bytes)
    log('%-12s %-10s tile %-14s estimate %9.2f us, measured %9.2f us back to '
        'back replayed (%.3fx; from Python: device %.2f, host %.2f us); '
        'share %.3f, ceiling %.3f; %d CTA(s)/SM planned, card %s; %d '
        'barriers a tile, %.2f evaluations an output; plan %s (%.1fs) | %s'
        % (name, e['form'], tuple(e['tile']), e['est_time_s'] * 1e6, us,
           ratio, python_us, host_us, share, e['ceiling_frac'],
           e['ctas_per_sm'], card_ctas,
            e['barriers_per_tile'], e['evaluations_per_output'],
            '== the built one' if same else 'DIFFERS from the built one',
            time.time() - t, smi))
    if not same:
      bad.append('%s: the estimate plans %s, the executor built %s' % (
          name, (e['form'], e['tile'], e['smem_bytes']),
          (est.form(plan), plan.tile, plan.smem_bytes)))
    if share > e['ceiling_frac'] * CEILING_SLACK:
      bad.append('%s: measured share %.3f over the ceiling %.3f' % (
          name, share, e['ceiling_frac']))
    if not EST_RANGE[0] <= ratio <= EST_RANGE[1]:
      bad.append('%s: estimate %.2fx the measured time' % (name, ratio))
  if bad:
    raise RuntimeError('estimate: %s' % '; '.join(bad))
  # nothing is timed from here on: the command line's runs, and phase
  # 25's NCCL runs (b), side by side
  from soda_tpu_torch import corpus, testing
  runs = nccl_start(here, env) + [('perf_report', start(
      ['-m', 'soda_tpu_torch.tools.perf_report', '--json'], here, env))]
  try:
    t = time.time()
    name, shape, _ = testing.CELLS[0]
    path = os.path.join(here, 'build', 'chip_smoke', name + '.soda')
    with open(path, 'w') as f:
      f.write(corpus.CORPUS[name])
    out = subprocess.run(
        [sys.executable, '-m', 'soda_tpu_torch', path, '--estimate', '-',
         '--shape', ','.join(map(str, shape)), '--tile-size', str(shape[1])],
        cwd=here, env=env, stdout=subprocess.PIPE, text=True, check=True,
        timeout=300).stdout
    got = json.loads(out)
    missing = [k for k in ESTIMATE_KEYS if k not in got]
    if missing or got['device'] != torch.cuda.get_device_name(0):
      raise RuntimeError('--estimate -: keys missing %s, device %r' % (
          missing, got['device']))
    log('--estimate - (%s %s): %d keys, device %s, estimate %.2f us, bound '
        '%.2f us (%s), ceiling %.3f, form %s, tile %s (%.1fs)' % (
            name, shape, len(got), got['device'], got['est_time_s'] * 1e6,
            got['ideal_time_s'] * 1e6, got['bound'], got['ceiling_frac'],
            got['form'], got['tile'], time.time() - t))
    rc, out, seconds = finish(runs.pop()[1], 300)
    if rc != 0:
      raise RuntimeError('perf_report --json: exit %d' % rc)
    report = json.loads(out)
    if len(report['rows']) != len(testing.CELLS) or \
        report['geomean_cells'] != len(testing.CELLS) - 1:
      raise RuntimeError('perf_report --json: %d rows, geomean over %d' % (
          len(report['rows']), report['geomean_cells']))
    log('perf_report --json: %d rows of %s (%s), geomean %.4f over %d cells '
        '(%.1fs)' % (len(report['rows']), report['record'], report['device'],
                     report['geomean'], report['geomean_cells'], seconds))
    nccl_finish(runs, log_ranks)
  finally:
    for _, (_, proc) in runs:
      if proc.poll() is None:
        proc.kill()
        proc.wait()


def start(cmd, here, env, merge=False):
  """(its start time, the process) of ``python cmd`` run in ``here``,
  its output piped (``merge``: its errors too)."""
  return time.time(), subprocess.Popen(
      [sys.executable] + cmd, cwd=here, env=env, stdout=subprocess.PIPE,
      stderr=subprocess.STDOUT if merge else None, text=True)


def finish(started, timeout):
  """(exit code, output, seconds since its start) of a ``start``ed
  process, killed if it outlasts ``timeout`` seconds from now."""
  t, proc = started
  try:
    out, _ = proc.communicate(timeout=timeout)
  except subprocess.TimeoutExpired:
    proc.kill()
    proc.communicate()
    raise
  return proc.returncode, out, time.time() - t


def nccl_start(here, env):
  """Phase 25 (b), started: the dry run's nine configs over NCCL at one
  rank a card, through ``torchrun --standalone`` and the dry run's own
  spawn (a FileStore, no port), side by side. [(how, started), ...]"""
  import torch
  n = torch.cuda.device_count()
  gate = ['-m', 'soda_tpu_torch.parallel.dryrun', '--backend', 'nccl']
  return [(how, start(cmd, here, env, merge=True)) for how, cmd in (
      ('torchrun', ['-m', 'torch.distributed.run', '--standalone',
                    '--nproc-per-node', str(n)] + gate),
      ('spawn', gate + ['--nproc', str(n)]))]


def nccl_finish(runs, log):
  """Waits for ``nccl_start``'s runs (emptying ``runs``); raises unless
  each printed the dry run's OK on every card."""
  import torch
  want = 'dryrun_multichip OK on %d ranks' % torch.cuda.device_count()
  while runs:
    how, started = runs.pop(0)
    rc, out, seconds = finish(started, 600)
    if rc != 0 or want not in out:
      raise RuntimeError('(b) NCCL %s: exit %d\n%s' % (how, rc, out[-3000:]))
    log('(b) NCCL through %s: %s, the nine configs against the oracle '
        '(%.1fs, beside phase 24\'s command-line runs)' % (how, want, seconds))


def record(name, source, replaces, launches, err, ms, plain_ms, stencil,
           shape, grids=1):
  """One entry of the ``{"kernels": ...}`` line (``library_ms`` None
  until a library call is timed)."""
  from soda_tpu_torch import profiling
  bound, bound_by = profiling.bound_ms(stencil, shape, grids)
  return {'name': name, 'route': 'cuda', 'source': source,
          'replaces': replaces, 'launches': launches, 'max_abs_err': err,
          'ms': ms, 'plain_ms': plain_ms, 'bound_ms': bound,
          'bound_by': bound_by, 'library_ms': None}


def sharded_cases(sharded_stencil, shape_of, calls=0):
  """The ``testing.SHARDED`` cells as the rank form's cases at their
  benchmark shapes (``calls``: back-to-back calls to time)."""
  from soda_tpu_torch import testing
  from soda_tpu_torch.parallel import dryrun
  return [dryrun.Case('%s %s %s%s' % (name, mesh_shape, inner,
                                      ' overlap' if overlap == 'on' else ''),
                      sharded_stencil(name, inner), shape_of[name],
                      mesh_shape, inner=inner, overlap=overlap, calls=calls)
          for name, mesh_shape, inner, overlap in testing.SHARDED]


def ranks_phase(by_name, sharded_stencil, plains, plain_ms_of, oracle, card,
                lib, here, env, smi, log):
  """Phase 25: the sharded executor's rank form, one process a shard.
  (a) ``RANKS`` gloo ranks on ``card`` (``dryrun.collect_world``; halos
  through host memory), and where the machine has ``RANKS`` cards also
  ``RANKS`` NCCL ranks, one a card, run the nine ``dryrun.configs`` and
  the ``testing.SHARDED`` cells at their shapes: each output bit for bit
  equal to the single-controller form on a mesh repeating ``card`` (the
  same kernels and halos; on its valid region, everywhere under
  ``border: preserve``), the nine against the oracle by the dryrun's
  rule, the cells against the unsharded plain version (blur against the
  oracle too), overlap on equal to off; each rank's launches (1 a shard
  for 'fused', a group's count for 'grouped'); each rank's device and
  host µs a call back to back, its kernel inner's alone (replayed from
  a CUDA graph, one rank at a time) and its halo bytes a call, beside
  the single-controller call's. (b), NCCL at one rank a card through
  ``torchrun`` and through the command line's own spawn, the nine
  configs, runs beside phase 24's command-line runs (``nccl_start``),
  before (a). Returns the kernel records of
  (a)'s kernel cells: ``ms`` is the sum of the ranks' inners alone, the
  card time of one call's launches over the whole grid without the host
  and the exchange."""
  import torch
  from soda_tpu_torch import profiling
  from soda_tpu_torch.parallel import dryrun, spmd
  from soda_tpu_torch.parallel.distributed import rank_mesh

  nine = dryrun.configs(RANKS)
  cases = nine + sharded_cases(sharded_stencil,
                               {n: c[1] for n, c in by_name.items()},
                               HOST_CALLS)
  # the single-controller form of each case on a mesh repeating the
  # card: its outputs, and each cell's back-to-back µs a call
  t = time.time()
  single, single_us = {}, {}
  for case in cases:
    ex = spmd.ShardedExecutor(
        case.stencil, case.shape, inner=case.inner, dim_axes=case.dim_axes,
        mesh=rank_mesh(case.mesh_shape, case.axis_names, [card] * RANKS),
        inner_opts=case.inner_opts, overlap=case.overlap)
    args = ex.prepare(*dryrun.inputs_of(case))
    single[case.label] = {
        n: o.gather()[tuple(slice(0, r) for r in case.shape)].cpu().numpy()
        for n, o in zip(case.stencil.output_names, ex.fn(*args))}
    if case.calls:
      profiling.settle(lambda: ex.fn(*args))
      single_us[case.label] = profiling.back_to_back_us(
          lambda: ex.fn(*args), calls=HOST_CALLS)
    del ex, args
  torch.cuda.synchronize()
  torch.cuda.empty_cache()
  log('single-controller form on meshes repeating %s: %d cases (%.1fs)' % (
      card, len(cases), time.time() - t))

  worlds = [('gloo', [card] * RANKS)]
  if torch.cuda.device_count() >= RANKS:
    worlds.append(('nccl', [torch.device('cuda', i) for i in range(RANKS)]))
  records = []
  for backend, devices in worlds:
    t = time.time()
    # gloo ranks share the one card; a NCCL rank takes cuda:LOCAL_RANK
    ranks = dryrun.collect_world(cases, RANKS, backend,
                                 card if backend == 'gloo' else None)
    log('(a) %d %s ranks on %s: %d cases run (%.1fs) | %s' % (
        RANKS, backend, '/'.join(str(d) for d in devices), len(cases),
        time.time() - t, ranks[0][0]['repr']))
    records += ranks_checked(cases, nine, ranks, backend, single, single_us,
                             plains, plain_ms_of, oracle, lib, smi, log)
    del ranks
  del single

  return records


def ranks_checked(cases, nine, ranks, backend, single, single_us, plains,
                  plain_ms_of, oracle, lib, smi, log):
  """Phase 25 (a)'s checks of one world's results (``ranks``: per rank,
  its results in case order) and its kernel records."""
  import numpy as np
  from soda_tpu_torch import testing
  from soda_tpu_torch.backend import grouped
  from soda_tpu_torch.parallel import dryrun, spmd

  records, offs = [], {}
  for i, case in enumerate(cases):
    results = [r[i] for r in ranks]
    got, stencil = results[0]['outputs'], case.stencil
    # bit for bit on the valid regions (everywhere under border:
    # preserve); a kernel need not write the cells outside them
    testing.check_exact(stencil, case.shape, got, single[case.label],
                        case.label + ': rank form vs single-controller form')
    if stencil.preserve_border and not all(
        np.array_equal(got[out], single[case.label][out])
        for out in stencil.output_names):
      raise RuntimeError('%s: the rank form differs from the '
                         'single-controller form outside the valid region'
                         % case.label)
    launches = [r['launches'] for r in results]
    per_rank = {'fused': 1, 'xla': 0, 'grouped': len(
        grouped.group_stencils(stencil)[1])}[case.inner]
    if launches != [per_rank] * RANKS:
      raise RuntimeError('%s: launches %s, want %d a rank' % (
          case.label, launches, per_rank))
    if i < len(nine):
      inputs, params = dryrun.inputs_of(case)
      dryrun.check(case, got, testing.oracle_run(stencil, inputs, params))
      log('%-28s == single-controller form bit for bit, oracle within %g; '
          'launches %s' % (case.label, dryrun.TOLERANCE, launches))
      continue
    cell = case.label.split()[0]
    err = testing.check_outputs(stencil, case.shape, got, plains[cell],
                                case.label + ' ranks vs unsharded plain')
    exact = ''
    if cell == FLAGSHIP:
      testing.check_outputs(stencil, case.shape, got, oracle,
                            case.label + ' ranks vs oracle')
      exact = ', bit-exact vs the NumPy oracle'
    if case.inner == 'xla' and case.overlap == 'off':
      offs[cell] = got
    elif case.inner == 'xla':
      for out in stencil.output_names:
        if not np.array_equal(got[out], offs[cell][out]):
          raise RuntimeError('%s:%s: overlap on differs from off' % (
              case.label, out))
      exact = ', == overlap off bit for bit'
    device_us = [r['device_us'] for r in results]
    host_us = [r['host_us'] for r in results]
    halo = [r['halo_bytes'] for r in results]
    inner_us = [r['inner_us'] for r in results]
    s_host, s_dev = single_us[case.label]
    per_rank_us = ['/'.join('-' if v is None else '%.1f' % v for v in vs)
                   for vs in (device_us, host_us, inner_us)]
    log('%-28s %s == single-controller form bit for bit, == unsharded plain '
        '(max |err| %.3g)%s; launches %s; per rank back to back (n=%d): '
        'device %s us a call, host %s us, the kernel inner alone (replayed, '
        'one rank at a time) %s us, halo bytes a call %s; single-controller form device '
        '%.1f us, host %.1f us | %s' % (
            case.label, backend, err, exact, launches, HOST_CALLS,
            *per_rank_us, '/'.join(str(v) for v in halo), s_dev, s_host,
            smi))
    if case.inner != 'xla':
      records.append(record(
          'fused_stencil_sharded[%s %s ranks%s]' % (
              cell, case.mesh_shape, '' if backend == 'gloo' else ' nccl'),
          'soda_tpu_torch/parallel/distributed.py', spmd.REPLACES,
          sum(launches), err, sum(inner_us) / 1e3, plain_ms_of[cell],
          stencil, case.shape))
      records[-1]['library_ms'] = lib.get(cell)
  return records


def layout_short_rows(stencil_of):
  """(cell, seed label, shape, stencil, keys) of phase 27: every row of
  ``testing.SEED_CONFIGS`` and ``testing.LAYOUT_EXTRA`` that carries a
  layout key (17 seeds and the 2 extras); ``stencil_of(name, overrides)``
  gives the row's stencil."""
  from soda_tpu_torch import testing
  from soda_tpu_torch.backend.layout import LAYOUT_KEYS
  rows = []
  seeds = testing.SEED_CONFIGS + testing.LAYOUT_EXTRA
  for index, (name, shape, overrides, keys) in enumerate(seeds):
    if not any(k in keys for k in LAYOUT_KEYS):
      continue
    label = ('seed %d' % (index % 2) if index < len(testing.SEED_CONFIGS)
             else 'extra')
    rows.append((name, label, shape, stencil_of(name, overrides), keys))
  return rows


def layout_short_sources(rows):
  """The kernel sources of phase 27: each row's new form, its old kernel
  (``_short=()``, the same keys) and its stencil's default kernel."""
  from soda_tpu_torch.backend import cuda_source
  from soda_tpu_torch.backend.tile_plan import kernel_plan, make_tile_plan
  out = []
  for _, _, shape, stencil, keys in rows:
    out += [cuda_source.generate(kernel_plan(stencil, shape, **keys)),
            cuda_source.generate(kernel_plan(stencil, shape, **keys,
                                             _short=())),
            cuda_source.generate(make_tile_plan(stencil, shape))]
  return out


def layout_short_phase(rows, lib, plain_ms, smi, log):
  """Phase 27 ``[layout-short]``: the layout keys on the short form. Per
  row of ``layout_short_rows``, the new form through
  ``get_executor(..., **keys)`` (its counter reset just before the user's
  call and read just after: one launch), bit for bit equal on the valid
  regions to the old kernel the same keys build with ``_short=()`` (the
  PR 5 layout form) and to the stencil's default kernel; after a settle
  run (a second of the default kernel's work for a cell's first row,
  then OPTION_SETTLE_S of the new form's), device µs a call replayed back
  to back (``profiling.replay_us``) as old, new, new, old, then the
  default kernel's; the form, tile,
  CTAs, the region's strip and register rows, registers, spills and
  barriers a tile. Returns the rows' kernel records (``library_ms``: the
  cell's, ``lib``; ``plain_ms``: the whole-grid plain version's ms by
  (cell, seed label), timed here where a row has none)."""
  import torch
  import soda_tpu_torch
  from soda_tpu_torch import profiling, testing
  from soda_tpu_torch.backend import cuda_source
  from soda_tpu_torch.backend.fused import FusedExecutor, fused_stencil_plain
  from soda_tpu_torch.model.compiled import compiled_stats
  records = []
  settled = set()
  for name, label, shape, stencil, keys in rows:
    t = time.time()
    new = soda_tpu_torch.get_executor(stencil, shape, **keys)
    old = FusedExecutor(stencil, shape, **keys, _short=())
    default = FusedExecutor(stencil, shape)
    plan, short = new.plan, new.plan.short
    if (not isinstance(new, FusedExecutor) or short is None or
        plan.warp is not None or old.plan.short is not None or
        plan.layout is None):
      raise RuntimeError('%s %s: not the short form against the old layout '
                         'form' % (name, keys))
    inputs = testing.make_test_inputs(stencil, shape)
    params = testing.make_test_params(stencil)
    new.launches = 0
    got = new(inputs, params)
    torch.cuda.synchronize()
    launches = new.launches
    if launches != 1:
      raise RuntimeError('%s %s: %d launches for one call' % (
          name, keys, launches))
    args = new.prepare(inputs, params)
    row = '%s %s %s' % (name, label, json.dumps(keys, sort_keys=True))
    old_out = dict(zip(stencil.output_names, old.fn(*args)))
    testing.check_exact(stencil, shape, got, old_out, row + ' vs the old form')
    err = testing.check_outputs(stencil, shape, got, old_out,
                                row + ' vs the old form')
    testing.check_exact(stencil, shape, got, dict(zip(
        stencil.output_names, default.fn(*args))),
                        row + ' vs the default kernel')
    del got, old_out
    n_in = len(stencil.input_names)
    p_ms = plain_ms.get((name, label))
    if p_ms is None:
      p_ms = statistics.median(profiling.cuda_times_ms(
          lambda: fused_stencil_plain(stencil, args[:n_in], args[n_in:]),
          reps=PLAIN_REPS, warmup=1))
    card = compiled_stats(new)['kernels'][0]
    card_old = compiled_stats(old)['kernels'][0]

    def b2b(e):
      return profiling.replay_us(lambda: e.fn(*args), calls=OPTION_CALLS)

    if name not in settled:  # a cell's first row: a second of its work
      profiling.settle(lambda: default.fn(*args))
      settled.add(name)
    profiling.settle(lambda: new.fn(*args), OPTION_SETTLE_S)
    seq = [b2b(old), b2b(new), b2b(new), b2b(old)]
    default_us = b2b(default)
    new_us = (seq[1] + seq[2]) / 2
    ratio = (seq[1] + seq[2]) / (seq[0] + seq[3])
    layout = plan.layout
    records.append(record(
        'fused_stencil_layout_short[%s %s: %s]' % (name, label, layout.name),
        'soda_tpu_torch/backend/cuda_source.py',
        cuda_source.LAYOUT_REPLACES[layout.form], launches, err,
        new_us / 1e3, p_ms, stencil, shape))
    records[-1]['library_ms'] = lib.get(name)
    bound = records[-1]['bound_ms']
    reg = short.region
    form = ('region %s: strip %d, %d-lane windows of %d, %d window(s), '
            'register rows %s, packed %s, ~%d words' % (
                '+'.join(reg.members), reg.strip, reg.lanes, reg.cells,
                reg.windows, ','.join('%s:%d' % (m, reg.rows(m))
                                      for m in reg.arrays),
                '+'.join(reg.packed) or 'none', reg.regs)
            if reg is not None else 'no region (%s)' % ', '.join(
                short.layout))
    log('%-12s %-7s %-30s %s tile %s, %d CTAs x %d steps, %d CTA(s)/SM '
        '(card %d), %d barriers a tile, %s%s; %d registers, spills %d/%d B '
        '(old %d, %d/%d B): 1 launch, == old form and default kernel bit for '
        'bit; back to back old, new, new, old %.1f/%.1f/%.1f/%.1f us/call '
        '(new/old %.3f), default %.1f us (new/default %.3f); bound %.4f ms, '
        'share new %.1f%% (%.1fs) | %s' % (
            name, label, layout.name, json.dumps(keys, sort_keys=True),
            plan.tile, plan.n_ctas, plan.steps, short.ctas,
            card['ctas_per_sm'], len(short.barriers), form,
            ' (off: %s)' % '; '.join('%s: %s' % kv for kv in sorted(
                short.off.items())) if short.off else '',
            card['registers'], card['spill_stores'], card['spill_loads'],
            card_old['registers'], card_old['spill_stores'],
            card_old['spill_loads'], *seq, ratio, default_us,
            new_us / default_us, bound, 100 * bound / (new_us / 1e3),
            time.time() - t, smi))
    del new, old, default, args
    torch.cuda.empty_cache()
  return records


def conformance_programs():
  """(group, label, stencil, inputs) of phase 28 at CONFORMANCE_SHAPE:
  every ``testing.FUZZ_SEEDS`` program, wide and narrow, on
  ``make_inputs``; every ``testing.CAST_SEEDS`` program on
  ``make_cast_inputs``; faults C5's and C6's programs
  (``testing.regression_cases``)."""
  from soda_tpu_torch import testing
  from soda_tpu_torch.api import build_stencil
  shape = CONFORMANCE_SHAPE
  out = []
  for narrow in (False, True):
    for seed in testing.FUZZ_SEEDS:
      stencil = build_stencil(testing.gen_program(seed, narrow))
      out.append(('fuzz narrow' if narrow else 'fuzz', 'fuzz%d' % seed,
                  stencil, testing.make_inputs(stencil, shape, seed)))
  for seed in testing.CAST_SEEDS:
    stencil = build_stencil(testing.gen_cast_program(seed))
    out.append(('cast', 'cast%d' % seed, stencil,
                testing.make_cast_inputs(stencil, shape, seed)))
  for label, text, _, inputs in testing.regression_cases(shape):
    out.append((label.split()[0], label, build_stencil(text), inputs))
  return out


def conformance_sources(programs):
  """The kernel sources of phase 28: each program's default kernel."""
  from soda_tpu_torch.backend import cuda_source
  from soda_tpu_torch.backend.tile_plan import make_tile_plan
  return [cuda_source.generate(make_tile_plan(stencil, CONFORMANCE_SHAPE))
          for _, _, stencil, _ in programs]


def conformance_phase(programs, smi, log):
  """Phase 28 ``[conformance]``: each of ``conformance_programs`` through
  ``get_executor(..., 'auto')`` (its counter reset just before the call
  and read just after: one launch), ``fused_stencil_plain`` on the card,
  ``get_executor(..., 'xla')`` on the card and the ``--emit-torch``
  program on the card, each held against the NumPy oracle run on the
  host: by ``check_outputs`` (integers bit-exact, floats within the
  threshold), and, for the conversion and fault programs, every output
  equal as a number (``check_exact(..., values=True)``: a float or
  double one rounding off fails); the fuzz programs' equality is
  counted. One line a group. Returns the phase's kernel record: the
  programs' launches, the kernel's largest error against the oracle, and
  the kernels', plain versions' and bounds' milliseconds summed over the
  programs (cold-L2 medians of CONFORMANCE_REPS calls)."""
  import types
  import numpy as np
  import torch
  import soda_tpu_torch
  from soda_tpu_torch import profiling, testing
  from soda_tpu_torch.backend import reference
  from soda_tpu_torch.backend.fused import FusedExecutor, fused_stencil_plain
  from soda_tpu_torch.backend.whole_grid import WholeGridExecutor
  from soda_tpu_torch.codegen import torch_source
  from soda_tpu_torch.backend import semantics
  shape = CONFORMANCE_SHAPE
  t = time.time()
  doubles, wides = testing.cast_values()
  card = torch.device('cuda', 0)
  x, u = torch.from_numpy(doubles).to(card), torch.from_numpy(
      wides.view(np.int64)).to(card)
  with np.errstate(over='ignore'):
    pairs = [('double -> half', semantics.half_of_double(x),
              x.to(torch.float16), doubles.astype(np.float16))] + [
                  ('uint64 -> %s' % np.dtype(dt).name,
                   semantics.float_of_u64(u, tdt),
                   u.to(torch.float64).add(torch.where(u < 0, 2.0 ** 64,
                                                       0.0)).to(tdt),
                   wides.astype(dt))
                  for dt, tdt in ((np.float64, torch.float64),
                                  (np.float32, torch.float32),
                                  (np.float16, torch.float16))]
  # values whose bits differ, where any NaN matches a NaN (CUDA's float
  # -> half gives its one NaN, 0x7fff, whatever the sign and payload)
  def differ(got, want):
    got = got.cpu().numpy()
    bits = 'u%d' % want.dtype.itemsize
    return int(((got.view(bits) != want.view(bits)) &
                ~(np.isnan(got) & np.isnan(want))).sum())

  for what, got, plain, want in pairs:
    bad, twice = differ(got, want), differ(plain, want)
    if bad:
      raise RuntimeError('%s on the card: %d of %d values differ from '
                         'numpy' % (what, bad, want.size))
    log('%-17s %d values next to rounding boundaries: == numpy bit for bit '
        '(NaN for NaN) on the card; torch\'s own conversion (the parent\'s) '
        'differs in %d (%.1fs) | %s' % (what, want.size, twice,
                                        time.time() - t, smi))
    t = time.time()
  launches, err, ms, plain_ms = 0, 0.0, 0.0, 0.0
  bounds = {'bytes': 0.0, 'operations': 0.0}
  groups = {}  # group -> [programs, equal as numbers on every path, s]
  for group, label, stencil, inputs in programs:
    t = time.time()
    with np.errstate(all='ignore'):
      want = reference.run(stencil, inputs)
    ex = soda_tpu_torch.get_executor(stencil, shape)
    wex = soda_tpu_torch.get_executor(stencil, shape, 'xla')
    if not isinstance(ex, FusedExecutor) or \
        not isinstance(wex, WholeGridExecutor):
      raise RuntimeError('%s: auto is not the fused kernel or xla not the '
                         'whole-grid executor' % label)
    ex.launches = 0
    got = {'kernel': ex(inputs)}
    torch.cuda.synchronize()
    if ex.launches != 1:
      raise RuntimeError('%s: %d launches for one call' % (label,
                                                            ex.launches))
    launches += ex.launches
    args = ex.prepare(inputs)
    got['plain'] = dict(zip(stencil.output_names,
                            fused_stencil_plain(stencil, args)))
    got['whole-grid'] = wex(inputs)
    module = types.ModuleType('emitted')
    exec(compile(torch_source.generate(stencil, shape), '<%s>' % label,
                 'exec'), module.__dict__)
    got['printed'] = module.compute(*args)
    torch.cuda.synchronize()
    equal = True
    for path, outs in got.items():
      where = '%s %s on the card vs the oracle' % (label, path)
      path_err = testing.check_outputs(stencil, shape, outs, want, where)
      if path == 'kernel':
        err = max(err, path_err)
      try:
        testing.check_exact(stencil, shape, outs, want, where, values=True)
      except AssertionError:
        if not group.startswith('fuzz'):
          raise
        equal = False
    del got
    ms += statistics.median(profiling.cuda_times_ms(
        lambda: ex.fn(*args), reps=CONFORMANCE_REPS))
    plain_ms += statistics.median(profiling.cuda_times_ms(
        lambda: fused_stencil_plain(stencil, args), reps=CONFORMANCE_REPS,
        warmup=1))
    bound, bound_by = profiling.bound_ms(stencil, shape)
    bounds[bound_by] += bound
    row = groups.setdefault(group, [0, 0, 0.0])
    row[0] += 1
    row[1] += equal
    row[2] += time.time() - t
    del ex, wex, args, module
  torch.cuda.empty_cache()
  for group, (n, n_equal, seconds) in groups.items():
    log('%-11s %d/%d programs at %s pass on the kernel (1 launch each), '
        'fused_stencil_plain, the whole-grid executor and the printed '
        'program against the NumPy oracle; %d/%d equal to it as numbers on '
        'every path (%.1fs) | %s' % (group, n, n, shape, n_equal, n,
                                     seconds, smi))
  return {'name': 'conformance', 'route': 'cuda',
          'source': 'soda_tpu_torch/backend/cuda_source.py',
          'replaces': 'soda_tpu/backend/pallas_kernel.py:1543',
          'launches': launches, 'max_abs_err': err, 'ms': ms,
          'plain_ms': plain_ms, 'bound_ms': sum(bounds.values()),
          'bound_by': max(bounds, key=bounds.get), 'library_ms': None,
          'programs': len(programs)}


def oneshot_phase(log):
  """Phase 17's one-shot part: the 37 one-shot bodies' default kernels
  (``vec_binary``, ``tile_fold``) beside their old forms (the first
  ``binary`` and ``fold``, ``narrow.launch(..., _old=True)``): each key
  SASS op kept in kind (``narrow.key_ops_kept``), registers, spills,
  CTAs an SM; then
  ``narrow_oneshot.run``: each body bit for bit against its plain
  version and its old form, replayed old, new, new, old and its library
  call, at the scripts' shapes and at erosion's bench shape. Returns
  narrow_oneshot's rows."""
  from soda_tpu_torch.experiments import narrow, narrow_oneshot
  changed = []
  for body in narrow_oneshot.ONE_SHOT:
    new_keys, old_keys = narrow.key_ops(body), narrow.key_ops(body, old=True)
    if not narrow.key_ops_kept(body):
      changed.append((body.name, old_keys, new_keys))
    geo = narrow.geometry(body)
    rep, old_rep = (narrow.sass_report(old)[(body.form, body.op)]
                    for old in (False, True))
    log('%-56s %s: regs %d, spills %d B, %d CTAs/SM, grid %d, smem %d B, '
        '%d instrs; old %s: regs %d, spills %d B, %d instrs; key ops %s '
        '(old %s)' % (
            body.name, narrow.KERNEL_NAMES[body.form], rep['registers'],
            rep['spills'], geo['ctas_per_sm'], geo['grid'], geo['smem'],
            rep['total'], body.form, old_rep['registers'], old_rep['spills'],
            old_rep['total'],
            ' '.join('%s %d' % kv for kv in new_keys.items()) or 'none',
            ' '.join('%s %d' % kv for kv in old_keys.items()) or 'none'))
  if changed:
    raise RuntimeError('narrow: one-shot kernels whose key SASS ops changed '
                       'kind %s' % changed)
  rows = narrow_oneshot.run(log=log)
  differ = [(r['body'], r['shape']) for r in rows if not r['ok']]
  if differ:
    raise RuntimeError('narrow: one-shot kernels differ from their plain '
                       'versions or old forms %s' % differ)
  return rows


def oneshot_main() -> int:
  """Phase 17's one-shot part alone (``python -c 'import chip_smoke;
  chip_smoke.oneshot_main()'``): the narrow probe built, then
  ``oneshot_phase``; one line a body and shape."""
  import torch
  if not torch.cuda.is_available():
    print('chip_smoke: no CUDA device', file=sys.stderr)
    return 1
  sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
  from soda_tpu_torch import profiling
  from soda_tpu_torch.backend import build
  from soda_tpu_torch.experiments import narrow
  say(profiling.device_report()['nvidia_smi'])
  t = time.time()
  build.build(build.csrc_source(narrow.SOURCE))
  say('[build] nvcc: %s (%.1fs)' % (narrow.SOURCE, time.time() - t))
  t = time.time()
  rows = oneshot_phase(lambda line: say('[narrow] ' + line))
  say('[narrow] %d one-shot timings (%.1fs)' % (len(rows), time.time() - t))
  return 0


def conformance_main() -> int:
  """Phase 28 alone (``python -c 'import chip_smoke;
  chip_smoke.conformance_main()'``): its programs' kernels built at once,
  then the phase; one line a group and the kernel record."""
  import torch
  if not torch.cuda.is_available():
    print('chip_smoke: no CUDA device', file=sys.stderr)
    return 1
  sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
  from soda_tpu_torch import profiling
  from soda_tpu_torch.backend import build
  smi = profiling.device_report()['nvidia_smi']
  say(smi)
  t = time.time()
  programs = conformance_programs()
  sources = list({s.digest: s for s in conformance_sources(programs)}.values())
  build.build_all(sources)
  say('[build] nvcc: %d kernels at once (%.1fs)' % (len(sources),
                                                    time.time() - t))
  t = time.time()
  entry = conformance_phase(programs, smi,
                            lambda line: say('[conformance] ' + line))
  say('[conformance] phase 28: %d programs (%.1fs)' % (entry['programs'],
                                                       time.time() - t))
  say(json.dumps(entry))
  return 0


def options_main() -> int:
  """Phase 26 alone at each of OPTION26_DEPTHS, in one run (``python -c
  'import chip_smoke; chip_smoke.options_main()'``): the cells' default
  kernels and the phase's built at once, each cell's plain version on the
  card, then the phase at each depth; one line a row, then each row's
  new/old ratio at the first depth and the last, and the largest
  difference."""
  import torch
  if not torch.cuda.is_available():
    print('chip_smoke: no CUDA device', file=sys.stderr)
    return 1
  sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
  import numpy as np
  import soda_tpu_torch
  from soda_tpu_torch import profiling, testing
  from soda_tpu_torch.backend import build, cuda_source
  from soda_tpu_torch.backend.fused import fused_stencil_plain
  from soda_tpu_torch.backend.tile_plan import make_tile_plan
  smi = profiling.device_report()['nvidia_smi']
  say(smi)
  t = time.time()
  stencils = {name: testing.build_cell(name, overrides)
              for name, _, overrides in testing.CELLS}
  shape_of = {name: shape for name, shape, _ in testing.CELLS}
  sources = [cuda_source.generate(make_tile_plan(stencils[name], shape))
             for name, shape in shape_of.items()]
  sources += option_sources(stencils, shape_of)
  sources = list({s.digest: s for s in sources}.values())
  build.build_all(sources)
  say('[build] nvcc: %d kernels at once (%.1fs)' % (len(sources),
                                                    time.time() - t))
  cells, plains = [], {}
  for name, shape in shape_of.items():
    stencil = stencils[name]
    ex = soda_tpu_torch.get_executor(stencil, shape)
    inputs = testing.make_test_inputs(stencil, shape)
    params = testing.make_test_params(stencil)
    cells.append((name, shape, stencil, ex, inputs, params))
    args = ex.prepare(inputs, params)
    n_in = len(stencil.input_names)
    plains[name] = dict(zip(stencil.output_names, fused_stencil_plain(
        stencil, args[:n_in], args[n_in:], tile=None)))
  _, shape, stencil, _, inputs, _ = cells[list(shape_of).index(FLAGSHIP)]
  oracle = testing.oracle_run(stencil, inputs)

  def check_oracle(got, context):
    for out in stencil.output_names:
      region = testing.output_valid_slices(stencil, shape, out)
      if not np.array_equal(got[out].cpu().numpy()[region],
                            oracle[out][region]):
        raise RuntimeError('%s:%s differs from the NumPy oracle' % (
            context, out))

  ratios = []
  for depth in OPTION26_DEPTHS:
    t = time.time()
    ratios.append({})
    options_phase(cells, plains, {name: float('nan') for name in shape_of},
                  {}, check_oracle, smi,
                  lambda line: say('[options] ' + line), depth, ratios[-1])
    say('[options] phase 26 at %d calls a reading, settles %g s and %g s '
        '(%.1fs)' % (*depth, time.time() - t))
  first, last = ratios[0], ratios[-1]
  change = {label: last[label] / first[label] - 1 for label in first}
  for label, c in change.items():
    say('[options] %-40s new/old %.4f at %d calls, %.4f at %d (%+.2f%%)' % (
        label, first[label], OPTION26_DEPTHS[0][0], last[label],
        OPTION26_DEPTHS[-1][0], 100 * c))
  worst = max(change, key=lambda label: abs(change[label]))
  say('[options] %d rows; largest change of a ratio %+.2f%% (%s) | %s' % (
      len(change), 100 * change[worst], worst, smi))
  return 0


def layout_short_main() -> int:
  """Phase 27 alone (``python -c 'import chip_smoke;
  chip_smoke.layout_short_main()'``): its rows' kernels built at once,
  then the phase; one line a row."""
  import torch
  if not torch.cuda.is_available():
    print('chip_smoke: no CUDA device', file=sys.stderr)
    return 1
  sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
  from soda_tpu_torch import profiling, testing
  from soda_tpu_torch.backend import build
  report = profiling.device_report()
  smi = report['nvidia_smi']
  say(smi)
  cache = {}

  def stencil_of(name, overrides):
    key = (name, repr(sorted(overrides.items())))
    if key not in cache:
      cache[key] = testing.build_cell(name, overrides)
    return cache[key]

  rows = layout_short_rows(stencil_of)
  t = time.time()
  sources = list({s.digest: s for s in layout_short_sources(rows)}.values())
  build.build_all(sources)
  say('[build] nvcc: %d kernels at once (%.1fs)' % (len(sources),
                                                    time.time() - t))
  t = time.time()
  records = layout_short_phase(rows, {}, {}, smi,
                               lambda line: say('[layout-short] ' + line))
  say('[layout-short] %d rows (%.1fs)' % (len(records), time.time() - t))
  return 0


def main() -> int:
  import torch
  if not torch.cuda.is_available():
    print('chip_smoke: no CUDA device; this check runs only on a GPU',
          file=sys.stderr)
    return 1
  here = os.path.dirname(os.path.abspath(__file__))
  sys.path.insert(0, here)
  import numpy as np

  import soda_tpu_torch
  from soda_tpu_torch import corpus, profiling, testing
  from soda_tpu_torch.backend import build, cuda_source, grouped
  from soda_tpu_torch.backend.fused import (FusedExecutor,
                                            fused_stencil_plain,
                                            replicated_stencil_plain)
  from soda_tpu_torch.backend.tile_plan import kernel_plan, make_tile_plan
  from soda_tpu_torch.experiments import (cluster_chain, exp1_value_mode,
                                          exp2_diag, exp12_mosaic_reprobe,
                                          exp13_narrow_i16,
                                          exp16_swar_erosion,
                                          exp24_stage_tax, exp27_gridloop,
                                          exp29_pack_i16,
                                          exp30_dma_granularity,
                                          exp32_dma_shift,
                                          exp45_transcendental_tax,
                                          exp9_layout25d, copyshift,
                                          layout25d, layout25d_replay, narrow,
                                          stream_replay)
  from soda_tpu_torch.experiments import probes as exp_probes
  from soda_tpu_torch.model.compiled import compiled_stats
  from soda_tpu_torch.parallel import dryrun, launch, replicate, spmd
  from soda_tpu_torch.tools import autotune, gpu_validate

  # 1. device
  t0 = t_start = time.time()
  report = profiling.device_report()
  launch.no_jax_loaded()
  say('[device] %s | torch %s | cuda %s | %s (%.1fs)' % (
      report['device'], report['torch'], report['cuda'], report['nvcc'],
      time.time() - t0))
  smi = report['nvidia_smi']
  say(smi)

  def times(fn, plain):
    k_ms = profiling.cuda_times_ms(fn, reps=KERNEL_REPS)
    p_ms = profiling.cuda_times_ms(plain, reps=PLAIN_REPS, warmup=1)
    return k_ms, statistics.median(k_ms), statistics.median(p_ms)

  # 2. build: every stencil first, then one nvcc per kernel source, all
  # started together, then the executors (which find their libraries)
  t_build = time.time()
  stencils, sources = {}, []
  for name, shape, overrides in testing.CELLS:
    t = time.time()
    stencils[name] = testing.build_cell(name, overrides)
    sources.append(cuda_source.generate(make_tile_plan(stencils[name],
                                                       shape)))
    say('[build] %-12s %-16s stencil %.1fs' % (name, shape, time.time() - t))
  overrides_of = {name: ov for name, _, ov in testing.CELLS}
  shape_of = {name: shape for name, shape, _ in testing.CELLS}
  coarse = {}
  for name in GROUPED:
    coarse[name] = testing.build_cell(name, dict(overrides_of[name],
                                                 cluster='coarse'))
    _, subs = grouped.group_stencils(coarse[name])
    sources += [cuda_source.generate(make_tile_plan(sub, shape_of[name]))
                for sub in subs]
  small = testing.build_cell(FLAGSHIP, overrides_of[FLAGSHIP])
  sources.append(cuda_source.generate(make_tile_plan(small, SMALL_SHAPE)))
  card = torch.device('cuda', 0)

  def sharded_stencil(name, inner):
    return coarse[name] if inner == 'grouped' else stencils[name]

  sources += dryrun.kernel_sources(sharded_cases(sharded_stencil, shape_of))
  # the kernel modes, and every configuration the tuner probes
  sources += [cuda_source.generate(kernel_plan(stencils[name], shape_of[name],
                                               **opts))
              for name, opts in testing.MODE_CELLS]
  for name in TUNED:
    sources += [cuda_source.generate(kernel_plan(stencils[name],
                                                 shape_of[name], **cfg))
                for cfg in autotune.candidate_configs(stencils[name],
                                                      shape_of[name])]
  # the layout forms: the JAX package's seeds and the narrow row (their
  # stencils are the cells' but for the extra rows' overrides), and the
  # default kernels of the extra rows' stencils
  layout_rows = []
  for name, shape, overrides, opts in (testing.SEED_CONFIGS +
                                       testing.LAYOUT_EXTRA):
    stencil = (stencils[name] if overrides == overrides_of[name] else
               testing.build_cell(name, overrides))
    if stencil is not stencils[name]:
      sources.append(cuda_source.generate(make_tile_plan(stencil, shape)))
    layout_rows.append((name, shape, stencil, opts))
    sources.append(cuda_source.generate(kernel_plan(stencil, shape, **opts)))
  # the layout rows' old forms (phase 27)
  layout_stencil = {(name, repr(sorted(overrides.items()))): row[2]
                    for (name, _, overrides, _), row in zip(
                        testing.SEED_CONFIGS + testing.LAYOUT_EXTRA,
                        layout_rows)}
  short_layout_rows = layout_short_rows(
      lambda name, overrides: layout_stencil[
          (name, repr(sorted(overrides.items())))])
  sources += layout_short_sources(short_layout_rows)
  # the validation gate's kernels (phase 14 runs it; it finds them built)
  gate_stencils = {}
  for _, name, variants, opts in gpu_validate.cases(True):
    sources += gpu_validate.sources(name, variants, opts, gate_stencils)
  sources += gpu_validate.sources('contrast', gpu_validate.F64_VARIANTS,
                                  cache=gate_stencils)
  # the experiment probes' hand-written sources (phases 16-18), and the
  # fused kernels exp1 and exp2 run (phase 17): the four CASES in value
  # mode (their vmem mode is the cells' default kernel), the copy stencil
  sources += [build.csrc_source(name) for name in exp_probes.SOURCES]
  for name, shape, overrides in exp1_value_mode.CASES:
    sources.append(cuda_source.generate(kernel_plan(
        testing.build_cell(name, overrides), shape, stage_mode='value')))
  for dtype in exp2_diag.COPY_TYPES:
    sources.append(cuda_source.generate(kernel_plan(
        exp2_diag.copy_stencil(dtype, exp2_diag.COPY_SHAPE),
        exp2_diag.COPY_SHAPE, block_rows=exp2_diag.BLOCK_ROWS)))
  # the many-stage form's element steps (phase 19), the short form's
  # (phase 20)
  sources += deep_sources(stencils[DEEP_CELL], shape_of[DEEP_CELL])
  sources += short_sources(stencils)
  # the public options on the short form and their old kernels (phase 26)
  sources += option_sources(stencils, shape_of)
  # the examples' kernels (phase 23)
  examples = example_modules(here)
  sources += example_sources(examples, card)
  # exp9's comparison rows (phase 18): the jacobi2d kernel at its block_rows
  exp9_stencil = corpus.build('jacobi2d', tile_size=exp9_layout25d.JACOBI_TILE)
  for block_rows in exp9_layout25d.JACOBI_BLOCK_ROWS:
    sources.append(cuda_source.generate(
        kernel_plan(exp9_stencil, exp9_layout25d.JACOBI_SHAPE,
                    block_rows=block_rows) if block_rows else
        make_tile_plan(exp9_stencil, exp9_layout25d.JACOBI_SHAPE)))
  # the rank form's kernel inners (phase 25): the nine dryrun configs at
  # RANKS ranks and at one rank a card
  sources += dryrun.kernel_sources(dryrun.configs(RANKS) +
                                   dryrun.configs(torch.cuda.device_count()))
  # the conformance programs' kernels (phase 28)
  conformance = conformance_programs()
  sources += conformance_sources(conformance)
  sources = list({src.digest: src for src in sources}.values())
  t = time.time()
  build.build_all(sources)
  say('[build] nvcc: %d kernels at once (%.1fs)' % (len(sources),
                                                    time.time() - t))
  cells = []
  for name, shape, overrides in testing.CELLS:
    stencil = stencils[name]
    ex = soda_tpu_torch.get_executor(stencil, shape)
    if not isinstance(ex, FusedExecutor):
      raise RuntimeError('%s: auto did not dispatch to the fused kernel' %
                         name)
    deep = ex.plan.deep
    say('[build] %-12s %-16s tile %-14s smem %6d B  %5d CTAs%s' % (
        name, shape, ex.plan.tile, ex.plan.smem_bytes, ex.plan.n_tiles,
        '  many-stage form: %d barriers a tile for %d stages, %d CTAs/SM' % (
            len(deep.barriers), len(ex.plan.stages), deep.ctas)
        if deep else ''))
    inputs = testing.make_test_inputs(stencil, shape)
    params = testing.make_test_params(stencil)
    cells.append((name, shape, stencil, ex, inputs, params))
  by_name = {c[0]: c for c in cells}
  say('[build] all %d cells (%.1fs)' % (len(cells), time.time() - t_build))

  # 3. main path: one run per cell through the user's entry point
  for cell in cells:
    cell[3].launches = 0
  results = {}
  t = time.time()
  for name, shape, stencil, ex, inputs, params in cells:
    results[name] = ex(inputs, params)
    torch.cuda.synchronize()
  launches = {cell[0]: cell[3].launches for cell in cells}
  say('[main] %s (%.1fs)' % (launches, time.time() - t))
  for name, count in launches.items():
    if count < 1:
      raise RuntimeError('%s: the main path launched no kernel' % name)

  def check_finite(stencil, shape, got, context):
    for out in stencil.output_names:
      region = testing.output_valid_slices(stencil, shape, out)
      if (stencil.symbol_table[out].is_float and
          not bool(torch.isfinite(got[out][region]).all())):
        raise RuntimeError('%s:%s: non-finite kernel output' % (context, out))

  # 4. kernel vs plain version on the card
  errors, plains = {}, {}
  for name, shape, stencil, ex, inputs, params in cells:
    t = time.time()
    args = ex.prepare(inputs, params)
    n_in = len(stencil.input_names)
    plain = fused_stencil_plain(stencil, args[:n_in], args[n_in:], tile=None)
    torch.cuda.synchronize()
    got = results[name]
    check_finite(stencil, shape, got, name)
    plains[name] = dict(zip(stencil.output_names, plain))
    worst = testing.check_outputs(stencil, shape, got, plains[name], name)
    errors[name] = worst
    say('[check] %-12s kernel == plain (max |err| %.3g) (%.1fs)' % (
        name, worst, time.time() - t))

  # 5. the flagship against the NumPy oracle
  t = time.time()
  name, shape, stencil, _, inputs, _ = by_name[FLAGSHIP]
  oracle = testing.oracle_run(stencil, inputs)

  def check_oracle(got, context):
    for out in stencil.output_names:
      region = testing.output_valid_slices(stencil, shape, out)
      if not np.array_equal(got[out].cpu().numpy()[region],
                            oracle[out][region]):
        raise RuntimeError('%s:%s differs from the NumPy oracle' % (
            context, out))

  check_oracle(results[name], name)
  say('[oracle] %s %s bit-exact vs the NumPy oracle (%.1fs)' % (
      name, shape, time.time() - t))

  # 6. times
  kernels, kernel_ms, plain_ms_of = [], {}, {}
  for name, shape, stencil, ex, inputs, params in cells:
    args = ex.prepare(inputs, params)
    n_in = len(stencil.input_names)
    k_ms, ms, plain_ms = times(
        lambda: ex.fn(*args),
        lambda: fused_stencil_plain(stencil, args[:n_in], args[n_in:]))
    q1, _, q3 = statistics.quantiles(k_ms, n=4)
    kernel_ms[name], plain_ms_of[name] = ms, plain_ms
    in_b, out_b = profiling.stream_bytes(stencil, shape)
    kernels.append(record('fused_stencil[%s]' % name,
                          'soda_tpu_torch/backend/cuda_source.py',
                          cuda_source.REPLACES, launches[name], errors[name],
                          ms, plain_ms, stencil, shape))
    say('[time] %-12s kernel %.4f ms (quartiles %.4f-%.4f, n=%d)  plain '
        '%.3f ms (n=%d)  %.1f GB/s unique traffic  bound %.4f ms (%s) | %s'
        % (name, ms, q1, q3, len(k_ms), plain_ms, PLAIN_REPS,
           (in_b + out_b) / ms / 1e6, kernels[-1]['bound_ms'],
           kernels[-1]['bound_by'], smi))
    torch.cuda.synchronize()

  # 7. host against device, back to back
  for name, shape, stencil, ex, inputs, params in cells:
    args = ex.prepare(inputs, params)
    host_us, device_us = profiling.back_to_back_us(lambda: ex.fn(*args),
                                                   calls=HOST_CALLS)
    say('[host] %-12s host %.1f us/call  device %.1f us/call  (%s, n=%d) '
        '| %s' % (name, host_us, device_us,
                  'host-bound' if host_us >= device_us else 'device-bound',
                  HOST_CALLS, smi))

  # 8. grouped: one kernel per stage group, handing off through memory
  groups, grouped_ms = {}, {}
  for name in GROUPED:
    groups[name] = soda_tpu_torch.get_executor(coarse[name], shape_of[name])
    if not isinstance(groups[name], grouped.GroupedExecutor):
      raise RuntimeError('%s: cluster: coarse did not dispatch to the '
                         'grouped executor' % name)
  for ex in groups.values():
    ex.launches = 0
  t = time.time()
  got_groups = {}
  for name, ex in groups.items():
    _, shape, _, _, inputs, params = by_name[name]
    got_groups[name] = ex(inputs, params)
    torch.cuda.synchronize()
  launches_g = {name: ex.launches for name, ex in groups.items()}
  say('[grouped] launches %s (%.1fs)' % (launches_g, time.time() - t))
  for name, ex in groups.items():
    _, shape, _, _, inputs, params = by_name[name]
    stencil = coarse[name]
    if launches_g[name] != len(ex.plan.groups):
      raise RuntimeError('%s: %d launches for %d groups' % (
          name, launches_g[name], len(ex.plan.groups)))
    got = got_groups[name]
    check_finite(stencil, shape, got, name + ' grouped')
    testing.check_outputs(stencil, shape, got, plains[name],
                          name + ' grouped vs ungrouped plain')
    args = ex.prepare(inputs, params)
    n_in = len(stencil.input_names)
    plain = grouped.grouped_stencil_plain(stencil, args[:n_in], args[n_in:])
    err = testing.check_outputs(stencil, shape, got,
                                dict(zip(stencil.output_names, plain)),
                                name + ' grouped')
    if name == FLAGSHIP:
      check_oracle(got, name + ' grouped')
    _, ms, plain_ms = times(
        lambda: ex.fn(*args),
        lambda: grouped.grouped_stencil_plain(stencil, args[:n_in],
                                              args[n_in:]))
    grouped_ms[name] = ms
    kernels.append(record('fused_stencil_grouped[%s]' % name,
                          'soda_tpu_torch/backend/grouped.py',
                          grouped.REPLACES, launches_g[name], err, ms,
                          plain_ms, stencil, shape))
    say('[grouped] %-10s %d groups, %d launches: == ungrouped plain and '
        '== grouped plain (max |err| %.3g)%s  kernels %.4f ms  plain %.3f '
        'ms  bound %.4f ms | %s' % (
            name, len(ex.plan.groups), launches_g[name], err,
            ', bit-exact vs the NumPy oracle' if name == FLAGSHIP else '',
            ms, plain_ms, kernels[-1]['bound_ms'], smi))

  # 9. replicated: R grids as the kernel's second grid axis
  reps = {}
  for name in REPLICATED:
    _, shape, stencil, _, _, params = by_name[name]
    grids = testing.replica_inputs(stencil, shape, REPLICAS)
    batch = {n: np.stack([g[n] for g in grids]) for n in stencil.input_names}
    ex = soda_tpu_torch.get_executor(stencil, shape, 'replicated',
                                     replication_factor=REPLICAS)
    reps[name] = (stencil, shape, ex, batch, params, REPLICAS)
  small_grids = testing.replica_inputs(small, SMALL_SHAPE, SMALL_REPLICAS)
  small_batch = {n: np.stack([g[n] for g in small_grids])
                 for n in small.input_names}
  small_name = '%s_%dx%d_r%d' % ((FLAGSHIP,) + SMALL_SHAPE +
                                 (SMALL_REPLICAS,))
  reps[small_name] = (small, SMALL_SHAPE, soda_tpu_torch.get_executor(
      small, SMALL_SHAPE, 'replicated', replication_factor=SMALL_REPLICAS),
                      small_batch, {}, SMALL_REPLICAS)
  for rep in reps.values():
    rep[2].launches = 0
  t = time.time()
  got_reps = {}
  for name, (_, _, ex, batch, params, _) in reps.items():
    got_reps[name] = ex(batch, params)
    torch.cuda.synchronize()
  launches_r = {name: rep[2].launches for name, rep in reps.items()}
  say('[replicated] launches %s (%.1fs)' % (launches_r, time.time() - t))
  for name, (stencil, shape, ex, batch, params, r) in reps.items():
    if launches_r[name] != 1:
      raise RuntimeError('%s: %d launches for one replicated call' % (
          name, launches_r[name]))
    args = ex.prepare(batch, params)
    n_in = len(stencil.input_names)
    plain = dict(zip(stencil.output_names,
                     replicated_stencil_plain(stencil, args[:n_in],
                                              args[n_in:])))
    got = got_reps[name]
    err = 0.0
    for k in range(r):
      got_k = {o: v[k] for o, v in got.items()}
      check_finite(stencil, shape, got_k, '%s replica %d' % (name, k))
      err = max(err, testing.check_outputs(
          stencil, shape, got_k, {o: v[k] for o, v in plain.items()},
          '%s replica %d' % (name, k)))
    _, ms, plain_ms = times(
        lambda: ex.fn(*args),
        lambda: replicated_stencil_plain(stencil, args[:n_in], args[n_in:]))
    kernels.append(record('fused_stencil_replicated[%s]' % name,
                          'soda_tpu_torch/parallel/replicate.py',
                          replicate.REPLACES, launches_r[name], err, ms,
                          plain_ms, stencil, shape, grids=r))
    say('[replicated] %-22s R=%d %s: 1 launch, every replica == plain (max '
        '|err| %.3g)  kernel %.4f ms  plain %.3f ms  bound %.4f ms | %s' % (
            name, r, shape, err, ms, plain_ms, kernels[-1]['bound_ms'], smi))
  # the small-grid regime replication exists for: one launch for 16
  # grids against 16 launches of the one-grid kernel, back to back
  _, _, ex_r, batch, _, _ = reps[small_name]
  args_r = ex_r.prepare(batch)
  ex_1 = soda_tpu_torch.get_executor(small, SMALL_SHAPE)
  singles = [ex_1.prepare(g) for g in small_grids]

  def sixteen():
    for a in singles:
      ex_1.fn(*a)

  one_ms = statistics.median(profiling.cuda_times_ms(lambda: ex_r.fn(*args_r),
                                                     reps=KERNEL_REPS))
  many_ms = statistics.median(profiling.cuda_times_ms(sixteen,
                                                      reps=KERNEL_REPS))
  _, one_us = profiling.back_to_back_us(lambda: ex_r.fn(*args_r), calls=50)
  _, many_us = profiling.back_to_back_us(sixteen, calls=50)
  say('[replicated] %s %s x %d: one launch %.4f ms vs %d launches %.4f ms '
      '(cold L2); back to back %.1f vs %.1f us per %d grids | %s' % (
          FLAGSHIP, SMALL_SHAPE, SMALL_REPLICAS, one_ms, SMALL_REPLICAS,
          many_ms, one_us, many_us, SMALL_REPLICAS, smi))
  # the same batch split over a mesh that repeats the card: one
  # replicated launch per entry of the mesh's first axis
  small_plain = replicated_stencil_plain(small, args_r)
  ex_m = soda_tpu_torch.get_executor(
      small, SMALL_SHAPE, 'replicated', replication_factor=SMALL_REPLICAS,
      mesh=testing.repeated_mesh(card, MESH_REPLICAS))
  ex_m.launches = 0
  t = time.time()
  got_m = ex_m(small_batch)
  torch.cuda.synchronize()
  launches_m = ex_m.launches
  if launches_m != MESH_REPLICAS[0]:
    raise RuntimeError('meshed replicated: %d launches on a %s mesh' % (
        launches_m, MESH_REPLICAS))
  err = 0.0
  for k in range(SMALL_REPLICAS):
    got_k = {o: v[k] for o, v in got_m.items()}
    check_finite(small, SMALL_SHAPE, got_k, 'mesh replica %d' % k)
    err = max(err, testing.check_outputs(
        small, SMALL_SHAPE, got_k,
        {o: v[k] for o, v in zip(small.output_names, small_plain)},
        '%s mesh replica %d' % (small_name, k)))
  args_m = ex_m.prepare(small_batch)
  _, ms, plain_ms = times(lambda: ex_m.fn(*args_m),
                          lambda: replicated_stencil_plain(small, args_r))
  kernels.append(record('fused_stencil_replicated[%s mesh %s]' % (
      small_name, MESH_REPLICAS), 'soda_tpu_torch/parallel/replicate.py',
                        replicate.REPLACES, launches_m, err, ms, plain_ms,
                        small, SMALL_SHAPE, grids=SMALL_REPLICAS))
  say('[replicated] %s on a %s mesh of %s: %d launches of %d grids, every '
      'replica == plain (max |err| %.3g)  kernels %.4f ms (one launch: %.4f '
      'ms)  plain %.3f ms  bound %.4f ms (%.1fs) | %s' % (
          small_name, MESH_REPLICAS, card, launches_m, ex_m.per_device, err,
          ms, one_ms, plain_ms, kernels[-1]['bound_ms'], time.time() - t,
          smi))

  # 10. the command line, as a user runs it
  cli_dir = os.path.join(here, 'build', 'chip_smoke')
  os.makedirs(cli_dir, exist_ok=True)
  # the tuner's default cache lies under HOME: keep it in the checkout
  env = dict(os.environ, PYTHONPATH=here, HOME=os.path.join(cli_dir, 'home'))

  def cli(runs, tag='cli'):
    """Run the command lines ``runs`` ((name, flags, shape, tile size))
    side by side, then check each: exit 0, INFO: PASS! and its kernel
    launches. A run that times the card (--bench, --tune) is given
    alone."""
    procs = []
    t = time.time()
    for i, (name, flags, shape, tile_size) in enumerate(runs):
      path = os.path.join(cli_dir, name + '.soda')
      with open(path, 'w') as f:
        f.write(corpus.CORPUS[name])
      cmd = [sys.executable, '-m', 'soda_tpu_torch', path, '--run',
             '--shape', shape, '--tile-size', tile_size] + flags
      log = open(os.path.join(cli_dir, '%s-%d.log' % (tag, i)), 'w+')
      procs.append((name, flags, cmd, log, subprocess.Popen(
          cmd, cwd=here, env=env, stdout=log, stderr=subprocess.STDOUT,
          text=True)))
    for name, flags, cmd, log, proc in procs:
      code = proc.wait(timeout=600)
      log.seek(0)
      out = log.read()
      log.close()
      for line in out.strip().splitlines():
        say('[%s] %s: %s' % (tag, name, line))
      if code != 0 or 'INFO: PASS!' not in out:
        raise RuntimeError('%s: %s exited %d without INFO: PASS!' % (
            name, ' '.join(cmd[1:]), code))
      found = re.search(r', (\d+) kernel launches$', out, re.M)
      count = int(found.group(1)) if found else -1
      if count < 0 or (count == 0) != ('xla' in flags):
        raise RuntimeError('%s %s: %d kernel launches' % (
            name, ' '.join(flags), count))
      say('[%s] %s %s: exit 0, INFO: PASS!, %d kernel launches (%.1fs for '
          'the %d run(s) side by side) | %s' % (
              tag, name, ' '.join(flags), count, time.time() - t, len(runs),
              smi))

  def timing(flags):
    return '--bench' in flags or '--tune' in flags

  cli_tile = CLI_SHAPE.split(',')[1]
  cli([(name, flags, CLI_SHAPE, cli_tile) for name, flags in CLI_RUNS
       if not timing(flags)])
  for name, flags in CLI_RUNS:
    if timing(flags):
      cli([(name, flags, CLI_SHAPE, cli_tile)])

  # 11. the whole-grid executor: plain PyTorch on the card
  for name, shape, stencil, ex, inputs, params in cells:
    t = time.time()
    wex = soda_tpu_torch.get_executor(stencil, shape, 'xla')
    got = wex(inputs, params)
    torch.cuda.synchronize()
    check_finite(stencil, shape, got, name + ' whole-grid')
    testing.check_outputs(stencil, shape, got, results[name],
                          name + ' whole-grid vs kernel')
    err = testing.check_outputs(stencil, shape, got, plains[name],
                                name + ' whole-grid vs plain')
    args = wex.prepare(inputs, params)
    w_ms = statistics.median(profiling.cuda_times_ms(lambda: wex.fn(*args),
                                                     reps=KERNEL_REPS))
    host_us, device_us = profiling.back_to_back_us(lambda: wex.fn(*args),
                                                   calls=WHOLE_GRID_CALLS)
    syncs = profiling.sync_count(lambda: wex.fn(*args))
    del got, args
    say('[whole-grid] %-12s == kernel and == plain (max |err| %.3g)  %.4f ms '
        'against the kernel\'s %.4f ms (%.1fx); back to back host %.1f us, '
        'device %.1f us per call (n=%d); %d synchronising operations per '
        'call (%.1fs) | %s' % (
            name, err, w_ms, kernel_ms[name], w_ms / kernel_ms[name], host_us,
            device_us, WHOLE_GRID_CALLS, syncs, time.time() - t, smi))
  torch.cuda.empty_cache()

  # 12. sharded: the grid split over meshes that repeat the card
  offs = {}
  for name, mesh_shape, inner, overlap in testing.SHARDED:
    _, shape, _, _, inputs, params = by_name[name]
    stencil = sharded_stencil(name, inner)
    t = time.time()
    ex = soda_tpu_torch.get_executor(
        stencil, shape, 'sharded', inner=inner, overlap=overlap,
        mesh=testing.repeated_mesh(card, mesh_shape))
    label = '%s %s %s%s' % (name, mesh_shape, inner,
                            ' overlap' if overlap == 'on' else '')
    ex.launches = 0
    got = ex(inputs, params)
    torch.cuda.synchronize()
    count = ex.launches
    per_shard = {'fused': 1, 'xla': 0,
                 'grouped': len(grouped.group_stencils(stencil)[1])}[inner]
    if count != ex.n_shards * per_shard:
      raise RuntimeError('%s: %d launches for %d shards x %d kernels' % (
          label, count, ex.n_shards, per_shard))
    check_finite(stencil, shape, got, label)
    err = testing.check_outputs(stencil, shape, got, plains[name],
                                label + ' vs unsharded plain')
    exact = ''
    if name == FLAGSHIP:
      testing.check_outputs(stencil, shape, got, oracle, label + ' vs oracle')
      exact = ', bit-exact vs the NumPy oracle'
    if inner == 'xla' and overlap == 'off':
      offs[name] = got
    elif inner == 'xla':
      for out in stencil.output_names:
        if not torch.equal(got[out], offs[name][out]):
          raise RuntimeError('%s:%s differs from overlap off' % (label, out))
      exact = ', == overlap off bit for bit'
    args = ex.prepare(inputs, params)
    ms = statistics.median(profiling.cuda_times_ms(lambda: ex.fn(*args),
                                                   reps=KERNEL_REPS))
    host_us, device_us = profiling.back_to_back_us(lambda: ex.fn(*args),
                                                   calls=HOST_CALLS)
    syncs = profiling.sync_count(lambda: ex.fn(*args))
    unsharded = grouped_ms[name] if inner == 'grouped' else kernel_ms[name]
    bound, _ = profiling.bound_ms(stencil, shape)
    if inner != 'xla':
      kernels.append(record(
          'fused_stencil_sharded[%s %s]' % (name, mesh_shape),
          'soda_tpu_torch/parallel/spmd.py', spmd.REPLACES, count, err, ms,
          plain_ms_of[name], stencil, shape))
    del got, args
    say('[sharded] %-34s %d shards, ext %s, %d launches: == unsharded plain '
        '(max |err| %.3g)%s  %.4f ms  unsharded %.4f ms (%.2fx)  bound %.4f '
        'ms; back to back host %.1f us, device %.1f us per call (n=%d); %d '
        'synchronising operations per call (%.1fs) | %s' % (
            label, ex.n_shards, ex.ext_shape, count, err, exact, ms,
            unsharded, ms / unsharded, bound, host_us, device_us, HOST_CALLS,
            syncs, time.time() - t, smi))

  # 13. kernel modes: the streaming loop, the cp.async ring, split
  # fills and staged stores, each through the user's entry point
  modes = []
  for name, opts in testing.MODE_CELLS:
    ex = soda_tpu_torch.get_executor(stencils[name], shape_of[name], **opts)
    if not isinstance(ex, FusedExecutor) or ex.config.is_default:
      raise RuntimeError('%s %s: not a mode kernel' % (name, opts))
    plan = ex.plan
    say('[build] %-12s %-22s tile %-14s smem %6d B  %4d CTAs x %d steps, %d '
        'slot(s)%s' % (name, cuda_source.mode_name(ex.config), plan.tile,
                       plan.smem_bytes, plan.n_ctas, plan.steps, plan.slots,
                       ', rolling' if plan.rolling else ''))
    modes.append((name, opts, ex))
  for name, opts, ex in modes:
    _, shape, stencil, _, inputs, params = by_name[name]
    ex.launches = 0
    t = time.time()
    got = ex(inputs, params)
    torch.cuda.synchronize()
    count = ex.launches
    args = ex.prepare(inputs, params)
    if count != 1:
      raise RuntimeError('%s %s: %d launches for one call' % (name, opts,
                                                              count))
    label = '%s %s' % (name, cuda_source.mode_name(ex.config))
    check_finite(stencil, shape, got, label)
    err = testing.check_outputs(stencil, shape, got, plains[name],
                                label + ' vs whole-grid plain')
    p_ms = plain_ms_of[name]
    exact = ''
    if name == FLAGSHIP:
      check_oracle(got, label)
      exact = ', bit-exact vs the NumPy oracle'
    k_ms = profiling.cuda_times_ms(lambda: ex.fn(*args), reps=KERNEL_REPS)
    ms = statistics.median(k_ms)
    _, device_us = profiling.back_to_back_us(lambda: ex.fn(*args),
                                             calls=HOST_CALLS)
    # the TPU code of the mode that sets this kernel apart
    lead = next(key for key in ('prefetch', 'dma_split', 'out_dma',
                                'stream_loop') if key in opts)
    kernels.append(record('fused_stencil_mode[%s]' % label,
                          'soda_tpu_torch/backend/cuda_source.py',
                          cuda_source.MODE_REPLACES[lead], count, err, ms,
                          p_ms, stencil, shape))
    bound = kernels[-1]['bound_ms']
    plan = ex.plan
    say('[modes] %-30s tile %s, %d CTAs x %d steps, %d slot(s)%s, smem %d B: '
        '1 launch, == whole-grid plain (max |err| %.3g)%s  kernel %.4f ms '
        '(default kernel %.4f ms, %.2fx)  bound %.4f ms (%.0f%%)  whole-grid '
        'plain %.1f ms  back to back %.1f us/call (%.1fs) | %s' % (
            label, plan.tile, plan.n_ctas, plan.steps, plan.slots,
            ', rolling' if plan.rolling else '', plan.smem_bytes, err, exact,
            ms, kernel_ms[name], ms / kernel_ms[name], bound,
            100 * bound / ms, p_ms, device_us, time.time() - t, smi))
    del got, args
  torch.cuda.empty_cache()

  # 14. tools: the tuner, the validation gate, compiled statistics, and
  # the command line's tuning flags
  tune_cache = os.path.join(cli_dir, 'tune.json')
  if os.path.exists(tune_cache):
    os.remove(tune_cache)
  timed = autotune._time_config
  probes = []

  def counted(*a, **k):
    probes.append(a[2])
    return timed(*a, **k)

  autotune._time_config = counted
  try:
    for name in TUNED:
      stencil, shape = stencils[name], shape_of[name]
      t = time.time()
      del probes[:]
      cfg = autotune.tune(stencil, shape, cache_path=tune_cache)
      first = len(probes)
      entry = next(e for e in autotune._load(tune_cache).values()
                   if e['stencil'] == stencil.app_name)
      # the first candidate is the default kernel's configuration
      default = entry['probes'][json.dumps(
          autotune.candidate_configs(stencil, shape)[0], sort_keys=True)]
      del probes[:]
      again = autotune.tune(stencil, shape, cache_path=tune_cache)
      if probes or again != cfg or not first:
        raise RuntimeError('%s: tune probed %d, then %d (%s, then %s)' % (
            name, first, len(probes), cfg, again))
      say('[tune] %-10s %d candidates probed: winner %s %.4f ms against the '
          'default kernel\'s %.4f ms (%.2fx); a second call probed 0 '
          '(%.1fs) | %s' % (name, first, cfg, entry['ms'], default,
                            default / entry['ms'], time.time() - t, smi))
      for probe, probe_ms in sorted(entry['probes'].items(),
                                    key=lambda kv: kv[1]):
        say('[tune] %-10s   %-50s %.4f ms' % (name, probe, probe_ms))
  finally:
    autotune._time_config = timed

  for name in COMPILED:
    stats = compiled_stats(by_name[name][3])
    for kernel in stats['kernels']:
      if kernel['registers'] is None or not kernel['ctas_per_sm']:
        raise RuntimeError('%s: compiled_stats gave %s' % (name, kernel))
      say('[compiled] %-10s %d registers/thread (ptxas %d), smem %d B static '
          '+ %d B dynamic, %d B local, spills %d/%d B, %d CTA(s)/SM; tile %s, '
          '%d CTAs, %d B in, %d B out | %s' % (
              name, kernel['registers'], kernel['registers_ptxas'],
              kernel['smem_static'], kernel['smem_dynamic'],
              kernel['local_bytes'], kernel['spill_stores'],
              kernel['spill_loads'], kernel['ctas_per_sm'],
              tuple(kernel['tile']), kernel['ctas'], kernel['bytes_in'],
              kernel['bytes_out'], smi))

  # the gate (its kernels were built in phase 2) beside the command
  # lines that time nothing
  t = time.time()
  gate_log = open(os.path.join(cli_dir, 'gpu_validate.log'), 'w+')
  gate = subprocess.Popen(
      [sys.executable, '-m', 'soda_tpu_torch.tools.gpu_validate',
       '--variants'], cwd=here, env=env, stdout=gate_log,
      stderr=subprocess.STDOUT, text=True)
  tool_runs = [(name, flags, ','.join(map(str, shape_of[name])),
                ','.join(map(str, overrides_of[name]['tile_size'][:-1])))
               for name, flags in TOOL_CLI_RUNS]
  cli([run for run in tool_runs if not timing(run[1])], tag='tools-cli')
  code = gate.wait(timeout=900)
  gate_log.seek(0)
  out = gate_log.read()
  gate_log.close()
  for line in out.strip().splitlines():
    say('[validate] %s' % line)
  rows = [line for line in out.splitlines()
          if re.match(r'\S+ +(PASS|FAIL|ERROR)', line)]
  if (code != 0 or any(' PASS' not in row for row in rows) or
      not any(row.startswith('contrast+f64truth ') for row in rows)):
    raise RuntimeError('gpu_validate --variants exited %d' % code)
  say('[validate] %d rows, every one PASS (%.1fs) | %s' % (
      len(rows), time.time() - t, smi))
  for run in tool_runs:
    if timing(run[1]):
      cli([run], tag='tools-cli')

  # 15. layout forms: the JAX package's 24 seed configurations (17 carry
  # a layout key) and its gate's narrow row, and chunked stage loops, at
  # the benchmark shapes, each through the user's entry point
  t15 = time.time()
  row_plain_ms = {}  # (cell, seed label) -> the plain version's ms
  for index, (name, shape, stencil, opts) in enumerate(layout_rows):
    t = time.time()
    ex = soda_tpu_torch.get_executor(stencil, shape, **opts)
    if not isinstance(ex, FusedExecutor):
      raise RuntimeError('%s %s: not the fused kernel' % (name, opts))
    plan = ex.plan
    layout = plan.layout
    form = (layout.name if layout is not None else
            cuda_source.mode_name(ex.config))
    inputs = testing.make_test_inputs(stencil, shape)
    params = testing.make_test_params(stencil)
    ex.launches = 0
    got = ex(inputs, params)
    torch.cuda.synchronize()
    count = ex.launches
    if count != 1:
      raise RuntimeError('%s %s: %d launches for one call' % (name, opts,
                                                              count))
    label = '%s %s' % (name, form)
    check_finite(stencil, shape, got, label)
    args = ex.prepare(inputs, params)
    n_in = len(stencil.input_names)
    if stencil is stencils[name]:
      default_out, default_ms = results[name], kernel_ms[name]
    else:
      default_ex = FusedExecutor(stencil, shape)
      default_out = default_ex(inputs, params)
      default_ms = statistics.median(profiling.cuda_times_ms(
          lambda: default_ex.fn(*args), reps=KERNEL_REPS))
    testing.check_exact(stencil, shape, got, default_out,
                        label + ' vs the default kernel')
    # the short form's plain version over the whole grid (walking the
    # plan's tiles takes seconds a row at these shapes): the same function
    # on every valid cell, bit for bit for a layout row
    if stencil is stencils[name]:
      want, p_ms = plains[name], plain_ms_of[name]
    else:
      want = dict(zip(stencil.output_names, fused_stencil_plain(
          stencil, args[:n_in], args[n_in:])))
      p_ms = statistics.median(profiling.cuda_times_ms(
          lambda: fused_stencil_plain(stencil, args[:n_in], args[n_in:]),
          reps=PLAIN_REPS, warmup=1))
    if layout is not None:
      testing.check_exact(stencil, shape, got, want,
                          label + ' vs the whole-grid plain version')
    err = testing.check_outputs(stencil, shape, got, want,
                                label + ' vs whole-grid plain')
    del want
    exact = ''
    if name == FLAGSHIP:
      check_oracle(got, label)
      exact = ', bit-exact vs the NumPy oracle'
    del got
    ms = statistics.median(profiling.cuda_times_ms(lambda: ex.fn(*args),
                                                   reps=KERNEL_REPS))
    _, device_us = profiling.back_to_back_us(lambda: ex.fn(*args),
                                             calls=HOST_CALLS)
    stats = compiled_stats(ex)['kernels'][0]
    cfg = ex.config
    lead = [k for k, on in (('prefetch', cfg.prefetch > 2),
                            ('dma_split', cfg.dma_split > 1),
                            ('out_dma', cfg.out_dma),
                            ('stream_loop', bool(cfg.stream_loop))) if on]
    replaces = (cuda_source.LAYOUT_REPLACES[layout.form] if layout else
                cuda_source.MODE_REPLACES[lead[0]] if lead else
                cuda_source.REPLACES)
    seed = ('seed %d' % (index % 2) if index < len(testing.SEED_CONFIGS)
            else 'extra')
    row_plain_ms[(name, seed)] = p_ms
    kernels.append(record('fused_stencil_layout[%s %s: %s]' % (
        name, seed, form), 'soda_tpu_torch/backend/cuda_source.py',
                          replaces, count, err, ms, p_ms, stencil, shape))
    bound = kernels[-1]['bound_ms']
    reg = plan.short.region if plan.short is not None else None
    say('[layout] %-12s %-7s %-40s %s tile %s, %d CTAs%s: 1 launch, '
        '== default kernel bit for bit, == %s%s  kernel %.4f ms (default '
        'kernel %.4f ms, %.2fx), max |err| %.3g  bound %.4f ms (%.1f%%)  '
        'plain %.1f ms  '
        'back to back %.1f us/call  %d registers, spills %d/%d B, %d B '
        'local, %d CTA(s)/SM (%.1fs) | %s' % (
            name, seed, form, json.dumps(opts, sort_keys=True), plan.tile,
            plan.n_ctas, (', region %s, strip %d, %d-lane windows, ~%d '
                          'words' % ('+'.join(reg.members), reg.strip,
                                     reg.lanes, reg.regs)
                          if reg else ', many-stage form, %d barriers a tile'
                          % len(plan.deep.barriers) if plan.deep else
                          ', short form' if plan.short else ''),
            'the whole-grid plain version bit for bit' if layout else
            'whole-grid plain', exact, ms, default_ms,
            ms / default_ms, err, bound, 100 * bound / ms, p_ms, device_us,
            stats['registers'], stats['spill_stores'], stats['spill_loads'],
            stats['local_bytes'], stats['ctas_per_sm'], time.time() - t,
            smi))
    del args
    torch.cuda.empty_cache()
  say('[layout] %d rows (%.1fs)' % (len(layout_rows), time.time() - t15))

  # 16. experiments: the streaming and chain probes through the
  # experiment entry points, every probe counter reset just before
  t16 = time.time()

  def log16(line):
    say('[experiments] ' + line)

  for name in exp_probes.SOURCES:
    report = build.ptxas_report(build.csrc_source(name))
    spills = sorted(entry for entry, r in report.items()
                    if r['spill_stores'] or r['spill_loads'])
    log16('%s: %d entries, registers %d-%d, spills in %s' % (
        name, len(report), min(r['registers'] for r in report.values()),
        max(r['registers'] for r in report.values()), spills or 'none'))

  def drive(run, *args):
    """One entry point's run, every probe counter reset just before and
    read just after: its rows and the launches of each configuration."""
    exp_probes.LAUNCHES.clear()
    rows = run('cuda', *args, log=log16)
    torch.cuda.synchronize()
    return rows, dict(exp_probes.LAUNCHES)

  stream_rows = {}
  for module, cases, line in ((exp27_gridloop, exp_probes.EXP27_CASES, 122),
                              (exp30_dma_granularity, exp_probes.EXP30_CASES,
                               110)):
    script = module.__name__.split('.')[-1]
    rows, launched = drive(module.run)
    for case, row in zip(cases, rows):
      stream_rows[case] = (row, launched.get(case.key, 0), script,
                           'experiments/%s.py:%d' % (script, line))
  chain_rows = {}
  for module, flag in ((exp24_stage_tax, False), (exp24_stage_tax, True),
                       (exp45_transcendental_tax, False),
                       (exp45_transcendental_tax, True)):
    rows, launched = drive(module.run, flag, CHAIN_N_SMALL, CHAIN_N_BIG)
    for row in rows:
      chain_rows.setdefault(row['body'], (
          row, launched.get(('probe_chain', row['body']), 0)))
  log16('main path: %d launches (%.1fs)' % (
      sum(n for _, n, _, _ in stream_rows.values()) +
      sum(n for _, n in chain_rows.values()), time.time() - t16))
  for name, n in ([(case.name, n) for case, (_, n, _, _) in
                   stream_rows.items()] +
                  [(name, n) for name, (_, n) in chain_rows.items()]):
    if n < 1:
      raise RuntimeError('%s: the experiments launched no kernel' % name)
  bad = [row['case'] for row, _, _, _ in stream_rows.values()
         if not row['ok']] + [b for b, (row, _) in chain_rows.items()
                              if not row['ok']]
  if bad or len(chain_rows) != len(exp_probes.CHAIN_BODIES):
    raise RuntimeError('experiments: wrong results in %s' % bad)

  # the streaming probe on the device alone: its SASS, then each case's
  # default kernel and old form held to the plain walk and x + 1 and
  # replayed old, new, new, old beside torch.add
  stream_replay.sass_check(log16)
  replayed = {row['case']: row for row in stream_replay.run(log=log16)}
  differ = [name for name, row in replayed.items() if not row['ok']]
  if differ:
    raise RuntimeError('experiments: stream kernels differ from their plain '
                       'versions or x + 1 in %s' % differ)
  x = exp_probes.stream_input(256, 'cuda')
  for case, (row, launches, script, replaces) in stream_rows.items():
    t = time.time()
    got = exp_probes.stream_probe(x, *case.args)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    want = exp_probes.stream_probe_plain(x, *case.args, ctas=row['ctas'])
    end.record()
    end.synchronize()
    p_ms = start.elapsed_time(end)
    err, _ = exp_probes.max_error(got, want)
    if err != 0 or not torch.equal(got, want):
      raise RuntimeError('%s: stream probe differs from its plain version'
                         % case.name)
    rep = replayed[case.name]
    us = {k: min(v) for k, v in rep['us'].items()}
    kernels.append({
        'name': 'probe_stream[%s %s]' % (script.split('_')[0], case.name),
        'route': 'cuda', 'source': 'soda_tpu_torch/csrc/probe_stream.cu',
        'replaces': replaces, 'launches': launches,
        'max_abs_err': err, 'ms': us['new'] / 1e3, 'plain_ms': p_ms,
        'bound_ms': row['bound_ms'], 'bound_by': 'bytes',
        'library_ms': us['library'] / 1e3})
    log16('%-18s == stream_probe_plain bit for bit; replayed %.2f us (old '
          '%.2f, torch.add %.2f; new/library %.3f), bound %.2f us (share '
          '%.3f); cold %.4f ms, %.3f us/step (%d CTAs x %d), back to back '
          '%.2f us, plain %.1f ms (%.1fs) | %s' % (
              case.name, us['new'], us['old'], us['library'],
              us['new'] / us['library'], row['bound_ms'] * 1e3,
              row['bound_ms'] * 1e3 / us['new'], row['ms'], row['step_us'],
              row['ctas'], row['steps'], row['b2b_us'], p_ms,
              time.time() - t, smi))
  del x, got, want
  torch.cuda.empty_cache()
  for name, body in exp_probes.CHAIN_BODIES.items():
    row, launches = chain_rows[name]
    x = exp_probes.chain_input(body.dtype, 'cuda')
    abs_err, rel_err = exp_probes.chain_check(
        x, body, exp_probes.CHECK_ITERS + (CHAIN_N_SMALL,))
    plain = lambda: exp_probes.chain_probe_plain(x, body, CHAIN_N_SMALL)
    if not exp_probes.chain_ok(body, abs_err, rel_err):
      raise RuntimeError('%s: chain probe differs from its plain version '
                         '(%g, relative %g)' % (name, abs_err, rel_err))
    p_ms = profiling.cuda_times_ms(plain, reps=1, warmup=0)[0]
    line = 75 if body.experiment == 'exp24' else 71
    script = ('exp24_stage_tax' if body.experiment == 'exp24' else
              'exp45_transcendental_tax')
    kernels.append({
        'name': 'probe_chain[%s %s]' % (body.experiment, name),
        'route': 'cuda', 'source': 'soda_tpu_torch/csrc/%s' % (
            narrow.SOURCE if body.form == 'shift' else 'probe_chain.cu'),
        'replaces': 'experiments/%s.py:%d' % (script, line),
        'launches': launches, 'max_abs_err': abs_err,
        'ms': row['us'] / 1e3, 'plain_ms': p_ms / CHAIN_N_SMALL,
        'bound_ms': row['bound_ms'], 'bound_by': 'operations',
        'library_ms': None})
    log16('%-14s == chain_probe_plain (n=%s, max |err| %.3g, relative %.3g);'
          ' per iteration %.3f us, bound %.3f us (%s), plain %.1f us, %d grid '
          '+ %d cluster barriers, %d CTAs | %s' % (
              name, ','.join(map(str, exp_probes.CHECK_ITERS +
                                 (CHAIN_N_SMALL,))), abs_err, rel_err,
              row['us'], row['bound_ms'] * 1e3, row['bound_by'],
              p_ms * 1e3 / CHAIN_N_SMALL, *body.barriers, row['ctas'], smi))
  # exp24's cluster bodies beside their old kernels: the SASS (the
  # cluster barrier in every cluster entry, no grid sync), each bit for
  # bit against its plain version and its old kernel, slopes old, new,
  # new, old
  t = time.time()
  cluster_chain.sass_check(log16)
  bad = [row['case'] for row in cluster_chain.run(
      cluster_chain.CASES, CHAIN_N_SMALL, CHAIN_N_BIG, log=log16)
         if not row['ok']]
  if bad:
    raise RuntimeError('experiments: cluster kernels differ from their plain '
                       'versions or old kernels in %s' % bad)
  log16('cluster kernels beside their old ones (%.1fs)' % (time.time() - t))
  log16('%d streaming cases, %d chain bodies (%.1fs)' % (
      len(stream_rows), len(exp_probes.CHAIN_BODIES), time.time() - t16))

  # 17. narrow: the 16-bit and op-rate probes through the six entry
  # points, every probe counter reset just before each and read just after
  t17 = time.time()

  def log17(line):
    say('[narrow] ' + line)

  narrow_rows, fused_rows = {}, []
  for module in (exp13_narrow_i16, exp29_pack_i16, exp16_swar_erosion,
                 exp12_mosaic_reprobe, exp2_diag, exp1_value_mode):
    exp_probes.LAUNCHES.clear()
    rows = module.run('cuda', log=log17)
    torch.cuda.synchronize()
    launched = dict(exp_probes.LAUNCHES)
    for row in rows:
      if row['body'] in narrow.BODIES:
        narrow_rows[row['body']] = (row, launched.get(
            (narrow.KERNEL, row['body']), 0))
      else:  # exp16's swar == wide, exp2's copies, exp1's stage modes
        fused_rows.append(row)
  log17('main path: %d launches (%.1fs)' % (
      sum(n for _, n in narrow_rows.values()), time.time() - t17))
  missing = sorted(set(narrow.BODIES) - set(narrow_rows))
  # (a body's row is not ok where it differs from its plain version or
  # its share of the bound exceeds narrow.MAX_SHARE)
  bad = [name for name, (row, n) in narrow_rows.items()
         if n < 1 or not row['ok']] + [row['body'] for row in fused_rows
                                       if not row['ok']]
  unlaunched = [row['body'] for row in fused_rows
                if 'launches' in row and row['launches'] < 1]
  if missing or bad or unlaunched:
    raise RuntimeError('narrow: bodies not run %s, wrong or not launched %s,'
                       ' fused kernels not launched %s' % (missing, bad,
                                                           unlaunched))
  spilled = {key: rep['spills'] for old in (False, True)
             for key, rep in narrow.sass_report(old).items() if rep['spills']}
  folded = sorted({body.op for body in narrow.BODIES.values()
                   if body.form == 'ew' and
                   not narrow.ew_loop_holds_every_iteration(body)})
  if spilled or folded:
    raise RuntimeError('narrow: kernels spill %s; register chains whose '
                       'iterations fold %s' % (spilled, folded))
  oneshot = oneshot_phase(log17)
  replayed = {r['body']: r for r in oneshot if r['shape'] == 'script'}
  for name, body in narrow.BODIES.items():
    row, launches = narrow_rows[name]
    xs = narrow.body_inputs(body, 'cuda')
    iters = narrow.check_iters(body, narrow.SLOPE.get(body.script, (1,))[0])
    abs_err, rel_err = narrow.narrow_check(body, xs, iters)
    if not narrow.narrow_ok(body, abs_err, rel_err):
      raise RuntimeError('%s: narrow probe differs from its plain version '
                         '(%g, relative %g)' % (name, abs_err, rel_err))
    # a one-shot body's ms: the default kernel replayed (the faster of its
    # two readings), its library call's the same way
    ms, library_ms = row['ms'], row['library_ms']
    if not body.chain:
      us = replayed[name]['us']
      ms = min(us['new']) / 1e3
      library_ms = (min(us['library']) / 1e3 if 'library' in us else None)
    kernels.append({
        'name': 'probe_narrow[%s]' % name, 'route': 'cuda',
        'source': 'soda_tpu_torch/csrc/probe_narrow.cu',
        'replaces': 'experiments/%s.py:%d' % (narrow.SCRIPTS[body.script],
                                              body.line),
        'launches': launches, 'max_abs_err': abs_err, 'ms': ms,
        'plain_ms': row['plain_ms'], 'bound_ms': row['bound_ms'],
        'bound_by': row['bound_by'], 'library_ms': library_ms})
    log17('%-56s == plain (n=%s, max |err| %.3g, relative %.3g); %s %.6g '
          'ms%s, bound %.6g ms (%s), plain %.6g ms, library %s, %d launches '
          '| %s' % (name, ','.join(map(str, iters)), abs_err, rel_err,
                    'per iteration' if body.chain else 'replayed', ms,
                    '' if body.chain else ' (cold %.6g ms; back to back: '
                    'host %.1f, device %.1f us a call)' % (
                        row['ms'], row['host_us'], row['b2b_us']),
                    row['bound_ms'], row['bound_by'],
                    row['plain_ms'], '%.6g ms' % library_ms
                    if library_ms is not None else 'none', launches,
                    smi))
  log17('%d bodies, %d other rows, %d one-shot timings (%.1fs)' % (
      len(narrow_rows), len(fused_rows), len(oneshot), time.time() - t17))

  # 18. copyshift: exp32's copy-shift probe and exp9's 2.5-D jacobi
  # through their entry points, every probe counter reset just before each
  # and read just after
  t18 = time.time()

  def log18(line):
    say('[copyshift] ' + line)

  for name in (copyshift.SOURCE, layout25d.SOURCE):
    report = build.ptxas_report(build.csrc_source(name))
    spills = sorted(entry for entry, r in report.items()
                    if r['spill_stores'] or r['spill_loads'])
    log18('%s: %d entries, registers %s, spills in %s' % (
        name, len(report), sorted(r['registers'] for r in report.values()),
        spills or 'none'))
    if spills:
      raise RuntimeError('copyshift: %s spills in %s' % (name, spills))
  runs = []
  for run, args in ((exp32_dma_shift.run, (False,)),
                    (exp32_dma_shift.run, (True,)), (exp9_layout25d.run, ())):
    exp_probes.LAUNCHES.clear()
    rows = run('cuda', *args, log=log18)
    torch.cuda.synchronize()
    runs.append((rows, dict(exp_probes.LAUNCHES)))
  copy_rows = [(row, launched) for rows, launched in runs[:2] for row in rows]
  rows9, launched9 = runs[2]

  def copy_key(case):
    return ((narrow.KERNEL, copyshift.ROTATE[case.name].name)
            if case.kind == 'rotate' else (copyshift.KERNEL, case.name))

  log18('main path: %d launches (%.1fs)' % (
      sum(sum(launched.values()) for _, launched in runs), time.time() - t18))
  bad = [row['case'] for row, launched in copy_rows
         if not row['ok'] or launched.get(
             copy_key(copyshift.CASES[row['case']]), 0) < 1]
  bad += [row['case'] for row in rows9 if not row['ok'] or (
      'block' in row and launched9.get((layout25d.KERNEL, 'block %d' %
                                        row['block']), 0) < 1)]
  if bad or len(copy_rows) != len(copyshift.CASES):
    raise RuntimeError('copyshift: wrong, over their bound or not launched: '
                       '%s' % bad)
  sass = copyshift.sass_report()
  order = copyshift.overlap_order(sass['overlap']['loop'])
  stores = copyshift.store_loop_counts(sass['store']['loop'])
  per = copyshift.CELL_SLOTS
  if order['between'] < 3 * per or min(stores.values()) < per:
    raise RuntimeError('copyshift: overlap order %s (chain B: 3 instructions '
                       'a cell slot between issue and wait), store loop %s' %
                       (order, stores))
  log18('SASS: the overlap\'s chain B has %d instructions between its copy\'s '
        'issue and the wait (%d after it, chain A\'s mins among them); the '
        'store control\'s main loop %d STS, %d LDS, %d mins, none forwarded' %
        (order['between'], order['after'], stores['STS'], stores['LDS'],
         stores['min']))
  for row, launched in copy_rows:
    case = copyshift.CASES[row['case']]
    kernels.append({
        'name': '%s[exp32 %s]' % (copy_key(case)[0], case.name),
        'route': 'cuda', 'source': 'soda_tpu_torch/csrc/%s' % (
            narrow.SOURCE if case.kind == 'rotate' else copyshift.SOURCE),
        'replaces': 'experiments/%s.py:%d' % (copyshift.SCRIPT, case.line),
        'launches': launched[copy_key(case)], 'max_abs_err': row['abs_err'],
        'ms': row['ms'], 'plain_ms': row['plain_ms'],
        'bound_ms': row['bound_ms'], 'bound_by': row['bound_by'],
        'library_ms': None})
  layout25d_replay.sass_check(log18)
  replayed9 = {row['block']: row for row in layout25d_replay.run(log=log18)
               if 'block' in row}
  # the new kernel's replayed time, the faster of its two readings
  replayed_ms = {block: min(row['us']['new']) / 1e3
                 for block, row in replayed9.items()}
  differs = [block for block, row in replayed9.items() if not row['ok']]
  over = [block for block, ms in replayed_ms.items()
          if not narrow.within_bound(layout25d.bound_ms(layout25d.SHAPE), ms)]
  if differs or over:
    raise RuntimeError('exp9: kernels differ from the plain version at '
                       'blocks %s; replayed over the bound at blocks %s' % (
                           differs, over))
  for row in rows9[1:]:
    if 'block' in row:
      kernels.append({
          'name': '%s[exp9 block %d]' % (layout25d.KERNEL, row['block']),
          'route': 'cuda', 'source': 'soda_tpu_torch/csrc/%s' %
          layout25d.SOURCE, 'replaces': 'experiments/%s.py:%d' % (
              layout25d.SCRIPT, layout25d.LINE),
          'launches': launched9[(layout25d.KERNEL, 'block %d' %
                                 row['block'])],
          'max_abs_err': row['abs_err'], 'ms': replayed_ms[row['block']],
          'plain_ms': row['plain_ms'], 'bound_ms': row['bound_ms'],
          'bound_by': 'bytes', 'library_ms': None})
    else:
      kernels.append(record(
          'fused_stencil[exp9 jacobi2d %s]' % row['case'].split()[-1],
          'soda_tpu_torch/backend/cuda_source.py',
          'soda_tpu/backend/pallas_kernel.py:1543', row['launches'],
          row['abs_err'], row['ms'], row['plain_ms'], exp9_stencil,
          exp9_layout25d.JACOBI_SHAPE))
  log18('%d exp32 cases, %d exp9 rows, each launched, bit for bit against '
        'its plain version and within %.2f of its bound (%.1fs) | %s' % (
            len(copy_rows), len(rows9), narrow.MAX_SHARE, time.time() - t18,
            smi))

  # 19. the many-stage form: contrast's default kernel against the
  # default form, element by element, and the library call
  t19 = time.time()
  name = DEEP_CELL
  lib_ms = deep_phase(stencils[name], shape_of[name], by_name[name][3],
                      plains[name], plain_ms_of[name], smi,
                      lambda line: say('[deep] ' + line))
  record_of = next(k for k in kernels
                   if k['name'] == 'fused_stencil[%s]' % name)
  record_of['library_ms'] = lib_ms
  say('[deep] phase 19 (%.1fs)' % (time.time() - t19))

  # 20. the short form: the other cells' default kernels against the
  # default form, element by element, and the library calls
  t20 = time.time()
  lib = short_phase(cells, plains, smi, lambda line: say('[short] ' + line))
  for name, ms in lib.items():
    next(k for k in kernels if k['name'] == 'fused_stencil[%s]' % name
         )['library_ms'] = ms
  # the same function on the same inputs for the paths that compute a
  # cell's function (kernel modes, layout forms, groups, shards), and
  # one batched call for the replicas
  lib[DEEP_CELL] = lib_ms
  for k in kernels:
    found = re.match(r'fused_stencil_(grouped|mode|layout|sharded)'
                     r'\[([^\s\]]+)', k['name'])
    if found and lib.get(found.group(2)) is not None:
      k['library_ms'] = lib[found.group(2)]
  for name, (stencil, shape, ex, batch, params, r) in reps.items():
    call = library_call(name, stencil, shape,
                        ex.prepare(batch, params)[0])
    if call is None:
      continue
    fn = call[0]
    single = library_call(name, stencil, shape,
                          ex.prepare(batch, params)[0][0])[0]
    first, want = fn()[0].double(), single().double()
    if float((first - want).abs().max()) > 1e-5 * float(want.abs().max()):
      raise RuntimeError('%s: the batched library call differs from the '
                         'single one' % name)
    ms = statistics.median(profiling.cuda_times_ms(fn, reps=KERNEL_REPS))
    next(k for k in kernels if k['name'] == 'fused_stencil_replicated[%s]'
         % name)['library_ms'] = ms
    say('[short] %-12s library, R=%d replicas in one batched call: %.4f ms '
        'cold | %s' % (name, r, ms, smi))
  say('[short] phase 20 (%.1fs)' % (time.time() - t20))

  # 21. one dispatch per call: chained runs and sharded calls replayed
  # from CUDA graphs, and fault C2's misaligned input
  t21 = time.time()
  graph_phase(by_name, oracle, card, smi, lambda line: say('[graph] ' + line))
  say('[graph] phase 21 (%.1fs)' % (time.time() - t21))

  # 22. the programs --emit-torch prints, on the card
  t22 = time.time()
  emit_phase(cells, results, kernel_ms, smi, lambda line: say('[emit] ' + line))
  say('[emit] phase 22 (%.1fs)' % (time.time() - t22))

  # 23. the port's examples at their default sizes
  t23 = time.time()
  examples_phase(examples, card, smi, lambda line: say('[examples] ' + line))
  say('[examples] phase 23 (%.1fs)' % (time.time() - t23))

  # 24. the cost model against the default kernels, --estimate and
  # perf_report
  t24 = time.time()
  estimate_phase(cells, here, env, smi,
                 lambda line: say('[estimate] ' + line),
                 lambda line: say('[ranks] ' + line))
  say('[estimate] phase 24 (%.1fs)' % (time.time() - t24))

  # 25. the rank form: one process a shard over torch.distributed
  t25 = time.time()
  kernels += ranks_phase(by_name, sharded_stencil, plains, plain_ms_of, oracle,
                         card, lib, here, env, smi,
                         lambda line: say('[ranks] ' + line))
  say('[ranks] phase 25 (%.1fs)' % (time.time() - t25))

  # 26. the public kernel options on the short form against the old
  # kernels they built before
  t26 = time.time()
  kernels += options_phase(cells, plains, plain_ms_of, lib, check_oracle,
                           smi, lambda line: say('[options] ' + line))
  say('[options] phase 26 (%.1fs)' % (time.time() - t26))

  # 27. the layout keys on the short form against the old layout forms
  t27 = time.time()
  kernels += layout_short_phase(short_layout_rows, lib, row_plain_ms, smi,
                                lambda line: say('[layout-short] ' + line))
  say('[layout-short] phase 27: %d rows (%.1fs)' % (
      len(short_layout_rows), time.time() - t27))

  # 28. conformance: the fuzz, conversion and fault programs through the
  # kernel, its plain version, the whole-grid executor and the printed
  # program, each against the NumPy oracle
  t28 = time.time()
  kernels.append(conformance_phase(conformance, smi,
                                   lambda line: say('[conformance] ' + line)))
  say('[conformance] phase 28: %d programs (%.1fs)' % (
      len(conformance), time.time() - t28))

  launch.no_jax_loaded()
  say('[done] every phase passed (%.1fs)' % (time.time() - t_start))
  say(smi)
  say(json.dumps({'kernels': kernels}))
  say(json.dumps({'ok': True, 'device': {
      'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
      'count': torch.cuda.device_count()}}))
  return 0


if __name__ == '__main__':
  sys.exit(main())
