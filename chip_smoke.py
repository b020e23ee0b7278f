#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one CUDA card and check them.

    python3 chip_smoke.py [--max-pages P]

Run from the root of a checkout on a machine with an NVIDIA GPU (Hopper:
the kernels build for sm_90a with nvcc, at first use, into
build/torch_kernels/). ``--max-pages`` cuts the block device's volume (1 GiB
by default), the one cut a short time limit may force. Float32 matrix
products and convolutions run in full fp32 (TF32 off). Phases, one JSON
line each (``t_s``: seconds since the script started); any failure raises
and the script exits non-zero:

1. env — torch/CUDA versions, the card's name and power limit.
2. build — compile every CUDA source of the port (csrc/*.cu: dbs_rw,
   dbs_copy, paged_attention and its bf16 and fp16 libraries,
   flash_attention, flash_attention_wgmma and its fp16 and fp32
   libraries, rwkv6_scan) with one nvcc each, all started together;
   seconds per library. Then launch_floor —
   the time per call of a one-element ``zero_()`` in the CUDA-graph
   harness of phase 3: the least any launched node costs there (printed
   beside ``dbs_rw_read`` and ``dbs_copy`` as ``launch_floor_ms``).
3. kernel_parity (dbs_rw_write) — at full width (pool (E+1, 32, 4096) f32,
   64 lanes), on write batches from the port's own ``write_pages`` over a
   seeded trace (in-place writes, CoW after a snapshot and a clone,
   duplicate-page groups with colliding blocks, holes, masked lanes): the
   CUDA kernel equals its plain version bit for bit. Times per batch come
   from CUDA graphs of one pass over the batches, median of 20 passes
   (kernel, plain version, and one PyTorch library call as a yardstick the
   port never calls), beside the bound (bytes over 3.35 TB/s, the H100 SXM
   HBM rate), with the kernel's registers, shared memory and blocks in
   flight. Then the kernel's other dtypes on the same batches: bf16 and
   uint8 copies of the pool and payloads (uint8: the [0, 1) floats scaled
   to bytes), bit for bit and timed the same way (``bf16_block_width_*``
   and ``uint8_block_width_*`` keys).
4. kernel_parity (dbs_copy) — the same at the block device's width, on the
   CoW batches (``cow_src``, ``dst``, ``cow_src >= 0``) of a second
   ``write_pages`` trace whose free ring hands extent 0 to a CoW lane: live
   copies, masked lanes with and without a dst, and a live copy into
   extent 0; bit for bit, not timed (phase 8 times it).
5. main_path — ``VolumeManager(backend="fused", kernel="cuda")`` with 3
   replicas, 4 KiB blocks, 32-block extent rows and a 1 GiB volume (8192
   pages): a seeded trace of 4 KiB random writes and reads, 128 KiB
   sequential spans, ~10% unaligned writes (read-modify-write), then a
   snapshot, CoW overwrites, a diverging clone, discards (full-page TRIM and
   partial edges) and a delete. Every read is checked against a host shadow;
   the replicas must agree; both kernels must have launched and the plain
   versions never. The read kernel's inputs of every 128th step are kept.
   After the trace, the host synchronisations of a window of 64 writes and
   64 reads are counted (sync-debug "warn").
6. kernel_parity (dbs_rw_read) — on the kept main-path inputs and the main
   path's own replica pool: bit for bit against the plain version, timed as
   in phase 3; hole lanes (zeros, no load) count one block in the bound.
   Then on bf16 and uint8 copies of that pool (exact: its fp32 lanes carry
   a byte each), the same batches, held and timed the same way.
7. storage_functions (``fused``): the five storage functions on the
   main volume through ``Volume.compute`` (per call, ``device_compute``),
   as in phase 8j. Then no_sync — one write pump's fused step under
   ``torch.cuda.set_sync_debug_mode("error")``.
8. block_device, ladder — the ladder's columns on the same trace cut to an
   sixteenth of its ops (an eighth until cut for the script's time), each
   checked as in phase 5, once each: the fused
   step on the hand-written kernels (``kernel="cuda"``), the fused step on
   the ``copy`` entry (``dbs_copy`` for the CoW rows, then a torch block
   scatter; it must launch ``dbs_copy`` and copy CoW lanes), and the
   unfused host-dispatched engine (``backend="slots"``); then
   ``backend="loop"`` over the first 300 ops. Ops/s, pumps and host
   synchronisations per pump for each. The ``copy`` column keeps the
   inputs of every 8th ``dbs_copy`` call; the kernel is held bit for bit
   against its plain version on them over the column's own pool and timed
   as in phase 3 (these are its ms and bound in the kernels line;
   ``zero_row_calls`` is the share of those calls that copy no row, on
   which ``index_copy_`` of the gathered rows launches nothing).
8a. controller_ladder — the paper's baseline and its first two steps on
   the same trace through the byte API, every read checked: ``upstream``
   (``UpstreamEngine``: one queue, one request a pump, chained stores) and
   ``+frontend`` (``loop`` over ``storage="chained"``) on the loop column's
   cut, ``+comm`` (``slots`` over ``storage="chained"``) on the ladder's
   cut; ops/s, MiB/s, pumps beside ``+dbs`` (``slots``) and ``+fused``;
   the three fold into the ladder line, which follows.
8b. layer_rows — every ported column (upstream, +frontend, +comm, +dbs,
   +fused, +sharded and +ring at S=4 with the main path's extents shared
   out;
   benchmarks/ladder.py's column map, copied) under the paper's
   three rows: ``frontend_only`` (``null_backend``), ``without_storage``
   (``null_storage``) and ``full_engine``, through the ``Engine`` request
   API (no byte API, no read check under the cuts): a seeded mix of 4 KiB
   block requests over 4 volumes, 2048 on the batched columns and 300 on
   the per-request ones, submitted again until the timed drains add up to
   at least MIN_WINDOW_S (0.25 s), after a warm-up drain; ops/s per cell.
8c. rebuild — the full trace of phase 5 on a fused/cuda manager with
   replica 1 failed (after a flush) once half the main path's op count was
   issued; then ``control("rebuild", replica=1)``, timed alone between two
   synchronisations, with its extents and bytes moved, messages by
   opcode, host milliseconds per opcode and bound (each moved row read
   once from the donor and written once to the target, at 3.35 TB/s).
   Checked: ``consistent()``, the rebuilt pool equals the donor's on every
   mapped row, every written block reads back right with replicas 0 and 2
   failed, and rebuilding 0 and 2 then moves no row and leaves three
   consistent replicas. Then three rebuilds of new deltas of the same row
   count (replica 1 fails again and one block of each of the first
   ``moved`` mapped pages is rewritten with the bytes it holds): timed
   (``warm``), timed after ``torch.cuda.empty_cache()``
   (``after_empty_cache``), and one under sync-debug "warn" for its host
   syncs (counted as in phase 5). The DBS kernels' launches on this path
   are counted.
8d. replication — the reference's policy matrix (benchmarks/ladder.py
   ``run_replication``) on ``slots`` over the ladder's cut trace, every read
   checked: ``local/all`` with 2 replicas, and ``simnet`` with 3 replicas,
   ``latency=[1, 1, 6]``, ``window=8`` under ``all``, ``quorum``,
   ``async`` and ``quorum`` with ``read_policy="latency"``; ops/s, the
   controller's wait in simulated ticks, retransmits, messages. After
   ``close()`` every case's replicas agree and every replica of every case
   holds the same volume bytes (a float64 checksum over the volume, on the
   card).
8e. snapshot_depth — one block of every page of a volume at the main
   path's geometry (8192 pages, 12288 extents; 32 volume slots for the
   snapshot table) under 0, 4, 16 and 64 snapshots (benchmarks/ladder.py
   ``snapshot_degradation``), rounds of 256 reads of random pages until
   the timed drains add up to at least MIN_WINDOW_S, on ``upstream`` and on
   ``fused``: reads/s and layers walked per read (the chain's depth plus
   one on upstream, one table gather on fused), every read checked.
8f. shards — ``VolumeManager(backend="sharded", n_shards=4)`` at the main
   path's geometry with its 12288 extents shared out (3072 a shard, the
   same 19.3 GB of pools): four base volumes, one a shard, share the
   ladder's cut trace (each snapshotted and cloned, every written block
   of every volume read back), every read checked, every shard's healthy
   replicas equal on their mapped rows. Ops/s, MiB/s, pumps, ops and host
   syncs a pump (the completion's event wait, which sync-debug does not
   report, counted in) beside the ``+fused`` column's; ``dbs_rw_write``
   and ``dbs_rw_read`` launches a pump must equal the fused column's per
   replica (one write a replica a write pump, one routed read a replica a
   pump). One pump then runs under sync-debug "error" from ``pump_async``
   to its event, and the kernels' calls kept from every 16th pump (S*B =
   256 lanes over the flattened (4*3073, 32, 4096) pool) are held bit for
   bit against the plain versions and timed as in phases 3 and 6 (the
   ``sharded_width_*`` keys of their kernels entries). The kept reads are
   mostly holes, so 8 dense read batches of S*B lanes over every shard's
   mapped rows (one lane in 16 a hole) are held and timed too
   (``sharded_dense_*``).
8g. table3_shards — benchmarks/table3_shards.py's protocol on the request
   API, ``full_engine`` row: rounds of 2048 4 KiB requests (half writes)
   over 8 volumes until MIN_WINDOW_S of timed drains, ``+fused`` against
   ``+sharded`` at S = 1, 2, 4, 8, all at 12288 extents in total; ops/s
   and the reference's ``check_scaling`` verdict (printed, not enforced).
   On the S=1 pool, host ms and aten ops a call of its metadata step
   (unmapped), of that step under ``torch.func.vmap``, of ``+fused``'s
   metadata, of its R routed reads and of one read launch
   (``sharded_s1_split``).
8h. shard_failover — the trace of 8f with shard 1's replica 1 failed
   halfway, writes going on; that slice alone rebuilt and timed, against
   the bound of its moved rows (2 x bytes / 3.35 TB/s). Checked: the
   rebuilt slice equals its donor; no message or row of shards 0, 2 and 3
   moved; with shard 1's other replicas failed every block written to its
   volume reads back right from the rebuilt replica alone.
8i. ring — ``VolumeManager(backend="ring")`` (the default backend) at
   the main path's geometry over the full trace of phase 5, every read
   checked: the trace's snapshots, clones, discards' unmaps and deletes
   are in-band requests in the ring's pumps. Ops/s, MiB/s, pumps, host
   syncs a pump (the completion's event counted in) beside the fused main
   path; write and read launches a pump per replica must equal the
   ``+fused`` column's; pumps by step signature.
8j. storage_functions (``ring``) — on the ring's main volume, in-band:
   ``checksum`` and ``scan_count`` over the whole 1 GiB range and a
   sub-range, ``filter_pages``, ``verify_on_read`` of a written block and
   of a hole, ``compare_and_write`` once not matching and once matching
   (the block then reads back committed). Each result must equal the
   numpy byte spec over the trace's shadow (``ByteSpec``; the port's
   ``np_blocksum`` for blocks). ms a call, the full range's bytes read and
   bound (the volume's float32 lanes once over 3.35 TB/s), the peak
   memory the calls add to the pools (at most 2 GiB: no whole-volume view
   is built). Then no_sync (``ring``): one pump with data and control
   lanes and one with compute lanes under sync-debug "error".
8k. ring_shards — the ring at S=4 on 8f's geometry and cut trace, shard
   1's replica 1 failed by an in-band FAIL request after half the ops and
   rebuilt by an in-band REBUILD request after three quarters (the step
   copies the donor's slice in place), every read checked, every shard's
   replicas equal at the end; the rebuild pump's ms against its bound
   (the slice's pool read once and written once over 3.35 TB/s), the
   phase's peak memory. Then the ring on the ``copy`` entry over the
   ladder's cut trace (it must launch ``dbs_copy``).
8l. journal — at the main path's geometry (``fused``/``cuda``), 4096
   4 KiB writes at scattered blocks (a stride of 7919 blocks: each lands
   on a page of its own), a flush every 64 and a durable flush at the
   end, on ``VolumeManager(journal=...)`` and on one without: a short
   warm-up each, a stream each with its host syncs a pump counted under
   sync-debug "warn" (they must be equal), then three timed streams
   each, interleaved: ops/s, the
   overhead of the best against the best, the ms a group commit and an
   fsync take inside the timed streams, the reference's gate (at most
   30%, benchmarks/ladder.py ``check_durability_gate``) printed as
   ``gate_met`` and not enforced, appends, records, journal bytes, the
   journal's directory (under TMPDIR) and its filesystem type.
8m. recovery — the journaled manager abandoned unclosed, half a record
   torn onto its tail, ``durability.recover`` into a fresh manager: timed,
   records and blocks replayed; the volume's digest must equal the
   crashed manager's and every written block must read back through the
   byte API. Then a fresh journaled stream with a ``SnapshotExport`` after
   its first half (``extents_moved`` must equal the delta: the mapped
   extents then), crashed and torn the same way and recovered with
   ``export=``: install timed alone, bytes across the bus each way,
   ``after_seq`` > 0, the same two checks. Then 2048 writes journaled on
   ``backend="ring"`` (the default), recovered by full replay and checked
   the same way. The DBS kernels' launches in each recovery (replay and
   read-back) are counted.
8n. tier — 512 of the volume's 8192 pages (cut for time) written whole
   and read back twice on the all-resident pool; then on
   ``VolumeManager(tier=...)``, written, the budget cut to 256 device
   extents (2x over-subscribed), and read back twice, every read checked:
   MiB/s of each, spills, fills, extents and bytes each way, host syncs a
   tiered pump (its second read pass, under sync-debug "warn") beside the
   untiered main path's; the tiered step must launch one ``dbs_rw_write``
   a replica a write pump and one ``dbs_rw_read`` a pump, and spill and
   fill both.
8o. harness — the chaos harness (``repro_torch.harness``: seeded fio-style
   traces, trace-indexed chaos schedules, the shadow byte oracle). Every
   catalog scenario (``SCENARIOS``: slots over local/simnet links with the
   all/quorum/async policies, the ring's in-band control, the sharded
   pool's all-shard replica chaos, storage functions in-band, crashes
   recovered from the journal) runs at the catalog's geometry (16 B
   blocks, 4-block pages, 32 pages), cut to 60 ops, on the card and on the
   CPU: the digests (completion ticks, the verification read-back bytes,
   retransmits) and ticks must be equal. Then every scenario at its own
   op count at the block device's widths (4 KiB blocks, 32-block pages,
   64-lane pumps, the main path's 12288-extent pool; the volume cut to 64
   pages, 8 MiB, because the end-of-trace sweeps read every volume and
   clone whole once a replica) on the hand-written kernels, the
   determinism replay, and ``check_trace_gates`` (oracle-clean, replay
   equal, the straggler wait-tick P99/P999 bounds) must return nothing;
   then ``run()`` on ``fused`` with 3 replicas on the ``cuda`` and the
   ``copy`` entries (which must launch ``dbs_copy``) and on the ring at one
   shard, over the chaos/simnet trace with ten events. Each card run: the
   DBS launches counted from zero (write and read must launch, the plain
   versions never), ops/s, wall and verification seconds, checked reads
   and computes, crashes, events applied and skipped, pump-tick
   P50/P99/P999 (all, read, write), wait ticks, transport counters, peak
   memory.
9. serve_path — zero-copy serving at gemma2-2b's full width (26 layers,
   d_model 2304, 8 heads, 4 KV heads, head_dim 256, vocab 256000; fp32
   weights drawn from a seeded ``torch.Generator`` on the card):
   ``ServeEngine(kv_backend="fused", kv_replicas=2, n_slots=8,
   max_len=2048, n_queues=2, kernel="cuda")`` with
   ``ExecutionPlan(attn_impl="cuda", compute_dtype="float32")``, so prefill
   runs the flash-attention kernel (every launch of its fp32 wgmma form,
   ``f32_wgmma``: 3xTF32 on wgmma fed by TMA, checked from
   ``LAUNCHES_BY_FORM``, and phase 10's kept calls report that form) and
   decode the paged-attention kernel over the block device's own extent
   pool (one 104 KiB block per token).
   16 requests with seeded prompt lengths in 100-1000 and 32 new tokens
   each (more requests than slots). Checked: every request ends with 32
   tokens, the replicas are consistent after a flush (the same metadata
   revisions and the same pool contents bar the dump row), no volume or
   extent is left after the drain, every kernel of the path launched
   (paged attention once a global layer a decode step, flash attention
   once a layer a prompt) and no plain version ran. The inputs of a few
   decode steps and of one prompt's local and global prefill layers are
   kept, and the DBS kernels' of every 8th write pump of the traffic (the
   read's, and replica 0's write). Phase 10 runs on them at once; then a
   fork check: a session forked after its 4th decode step, and a second
   engine decoding the same two streams independently, must give the same
   tokens (the largest logit difference is printed). Phases 9-10 are one
   helper, ``_serve_traffic``, that phases 19-20 run too.
10. kernel_parity (paged_attention, flash_attention) — each kernel against
   its plain version on those kept full-width inputs, over the serve
   path's own pool as the traffic left it, within atol 1e-4 and rtol 1e-4;
   timed with CUDA graphs
   as in phase 3, beside the bound (paged: live K/V pages plus q and the
   output over 3.35 TB/s; flash: the larger of its causal flops over
   165 TFLOP/s, the fp32 rate of 3xTF32 on the tensor cores that it
   computes with, and its bytes over 3.35 TB/s) and one PyTorch yardstick
   labelled with what it differs in; each with its registers, shared
   memory and blocks in flight, paged also with its split count (shares of
   each sequence's pages over blocks) and kernels per call (the main grid,
   then the merge of the partials when it splits). Then ``dbs_rw_read``
   at the serving width (pool (E+1, 32, 26624) f32, the serve path's own
   replica 0, 104 KiB blocks) on the kept pump inputs: bit for bit, timed
   as in phase 6; and ``dbs_rw_write``'s kept calls replayed in order on
   two copies of that pool, through the kernel and through its plain
   version: bit for bit, timed as in phase 3 (the ``serve_width_*`` keys
   of their kernels entries).
11. no_sync (serving) — one call of the decode program under
   ``torch.cuda.set_sync_debug_mode("error")``.
12. profile (serving) — where a serving step's time goes, on the same
   engine: eight requests fill the slots; four decode steps are timed,
   four more run under ``torch.profiler``, then a ninth prompt's prefill
   into the slot a finished request freed, and the write pumps that land
   its K/V. One line per part: wall time, the device's busy time and idle
   share, device events, and the operators that took the most time.
13. serve_path (``kv_backend="host"``) — the copy-based baseline with the
   same settings and the same 16 requests: the host backend allocates
   pages, model-owned pools hold the K/V (1032 x 32 x 4 x 256 floats each,
   K and V of 13 global layers), prefill runs the flash kernel, decode the
   plain paged gather. Every request ends with 32 tokens and nothing
   leaks; then the fork check on this backend, whose CoW launches
   ``dbs_copy`` once per pool (26 calls), kept for phase 14; then eight
   requests fill the slots and four decode steps run under
   ``torch.profiler`` (a "profile" line as in phase 12).
14. kernel_parity (dbs_copy) at the serving width (128 KiB rows), on those
   kept calls: bit for bit, timed as in phase 8.
15. host_vs_zero_copy — four requests, eight new tokens, on both backends:
   logits within atol 1e-3 and rtol 1e-3, tokens equal (the largest
   difference and the smallest top-2 margin are printed).
16. serve_pool — ``ServePool`` of two zero-copy engines (4 slots,
   max_len 512 each): five requests, a fork that stays on its parent's
   shard; everything completes, no leak, replicas consistent.
16a. serve_path (``kv_backend="sharded"``) — phase 9's engine and 16
   requests on two KV shards (1032 extents each, 2 KV replicas): tokens
   equal phase 9's under the TIE_MARGIN rule (top-2 margins from a
   ``topk`` on the card each step), the paged kernel reads the flattened
   2*(E+1)-row pool, replicas agree, nothing leaks; tokens/s, decode
   tokens/s, peak memory. Then four of the requests admitted with shard
   0's replica 1 failed, that slice rebuilt mid-decode (delta and
   live-row resync), shard 0's replica 0 failed: the rebuilt replica
   alone serves to phase 9's tokens.
16b. serve_path (``kv_backend="ring"``) — phase 9's engine on the ring,
   2 KV replicas, its first four requests: the KV writes ride the ring's
   pumps and the sessions' deletes its in-band control; tokens equal
   phase 9's under the TIE_MARGIN rule, the replicas agree, nothing
   leaks.
17. serve_path (rwkv6-3b) — RWKV-6 serving at its published widths (32
   layers, d_model 2560, 40 heads of 64, d_ff 8960, vocab 65536, untied
   head; fp32 weights drawn from a seeded generator on the card, after
   gemma2's are freed): ``ServeEngine(kv_backend="host", n_slots=8,
   max_len=2048, n_queues=2)`` with ``ExecutionPlan(attn_impl="cuda",
   compute_dtype="float32")``, so prefill and decode run the recurrence
   through the ``rwkv6_scan`` kernel from each slot's carried state. 16
   requests with seeded prompt lengths in 100-1000 (at least one of them a
   length the reference's prefill cannot chunk, such as 513) and 32 new
   tokens each. Checked: every request ends with 32 tokens; the kernel
   launched once per layer per prompt and per decode step, its plain
   version never, and ``dbs_copy`` never (there is no KV pool); no volume
   or extent leaks; a request served in a recycled slot equals the same
   request served alone in a fresh engine; the fork check of phase 9 (the
   fork copies the parent's recurrent state); eight requests fill the
   slots and four decode steps run under ``torch.profiler`` (a "profile"
   line as in phase 12); one ``M.decode_step`` under sync-debug "error". The kernel's inputs of layer 0 of every prompt and
   of the first layers of a few decode steps are kept.
18. kernel_parity (rwkv6_scan) — the kernel against its chunked plain
   version and the step-by-step oracle on those kept inputs and on crafted
   ones (ragged and prime lengths, a carried state, hd 16 to 64), and
   against the oracle alone on strong decay (logw about -3 a token, where
   the chunked version's exp(-cum) overflows), within rtol 1e-4 and atol
   1e-4 widened to 1e-5 of the reference's largest magnitude (long prompts
   grow the outputs to hundreds; the measured errors are printed); timed
   with CUDA graphs as in phase 3, per decode and per prefill call, beside
   the bound (the larger of its bytes over 3.35 TB/s and the chunked
   form's flops at the rates of the units that run them: the decode
   schedule's all at 67 TFLOP/s, the CUDA cores' fp32; the prefill's
   products at 3xTF32's 165 and its bonus and diagonal triangles at 67,
   ``_rwkv_op_seconds``), with the schedule, column blocks, registers
   and shared memory the kernel reports for each. No
   single PyTorch call computes the recurrence, so its library time is
   null; the kernels line gives the times per launch over the serve path's
   mix of prefill and decode launches. Then the bf16 form: the kept decode
   and prefill calls with r, k, v, logw and u rounded to bf16 (the state
   fp32) against the plain chunked version on the same inputs, the state
   within RWKV_TOL's terms and y (bf16) within them plus one bf16 step of
   |y|; every launch of the bf16 form; timed the same way, its bound at
   2-byte inputs (``bf16_prefill_width_*``, ``bf16_decode_width_*``).
19. serve_path (hymba-1.5b) — the hybrid family at its published widths
   and depth (32 layers, d_model 1600, 25 heads over 5 KV heads of 64,
   attention and a Mamba branch (E 3200, N 16) in every layer, a
   1024-token window but on layers 0, 15 and 31, d_ff 5504, vocab 32001;
   fp32 weights from a seeded generator on the card, after rwkv6-3b's are
   freed) on phase 9's engine (``fused``, 2 KV replicas, 8 slots,
   max_len 2048, ``kernel="cuda"``, ``attn_impl="cuda"``): the three
   global layers' K/V in the extent pool (6 planes of (5, 64)), the
   window rings and the Mamba states in per-slot caches. 16 requests of
   32 new tokens, prompts drawn in 100-1000 but two of 1100-1500 tokens
   (the window bites in prefill and the rings wrap) and one of 513 (a
   length the reference's Mamba prefill rejects). Checked: every request
   ends with 32 tokens; the replicas agree after a flush and nothing
   leaks; ``dbs_rw_write``, ``dbs_rw_read``, ``flash_attention`` (32 a
   prompt, every launch ``f32_wgmma`` as in phase 9) and
   ``paged_attention`` (3 a decode step) launched and no plain version
   ran; the last request, in a recycled slot, equals a
   fresh engine's (the TIE_MARGIN rule); the fork check of phase 9; one
   decode step under sync-debug "error"; the copy-based baseline
   (``kv_backend="host"``) on the same prompts gives the same tokens
   (TIE_MARGIN rule on the zero-copy run's top-2 margins, taken on the
   card). Kept paged calls (the first 4 of decode steps 8, 24, 40: G=5,
   two row groups), flash calls (a global and a windowed layer of the
   first prompt past the window) and the DBS kernels' inputs of every 8th
   write pump (7.5 KiB blocks) are held against the plain versions and
   timed as in phase 10, right after the traffic (the ``hybrid_width_*``
   keys of their kernels entries); the baseline's split-pool decode calls
   of its 8th step (the first 4 paged layers) are held against the
   split-pool entry of the paged kernel (``hybrid_split_*`` keys). Nothing
   but 2 GB may be allocated at the phase's start.
   Printed: tokens/s, decode tokens/s, prefill, pump and decode seconds,
   the prefill seconds of the 513-token and the longest prompt, peak
   memory, and one profiled decode step's device time split into
   attention (KV writes and reads), the Mamba branch and the rest, with
   its kernels a step.
20. serve_path (granite-moe-3b-a800m) — the MoE family the same way (32
   layers, d_model 1536, 24 heads over 8 KV heads of 64, 40 experts of
   d_ff 512, top 8, vocab 49155; 13.2 GB of fp32 weights): all 32 layers
   paged (64 planes of (8, 64), 128 KiB a token), prompts drawn in
   100-1000; the MoE runs every expert on every token with zero combine
   weights for the unselected ones, in prefill and decode (nothing read
   back). The same checks and prints, G=3 (one partial row
   group) in the kept paged calls, two prompts' layer-0 flash calls, 128
   KiB blocks in the DBS kernels' calls; the split names the MoE instead
   of the Mamba branch (``moe_width_*`` keys).
21. serve_path (deepseek-v3-671b) — MLA and 256 experts at every published
   width (d_model 7168, 128 heads, q_lora 1536, kv_lora 512, rope 64, nope
   128, v 128, 256 routed experts of d_ff 2048 top 8 with a shared one,
   dense d_ff 18432, vocab 129280) with the depth cut to its three dense
   layers and its first MoE layer (MLA_LAYERS; 61 published; 63 GB of fp32
   weights with the MTP head, 5 layers would take 106 GB). Phase 19's
   engine, traffic and checks; the engine pool holds one latent KV head a layer (8 planes of
   (1, 576): 18 KiB a token), so decode runs the paged kernel's packed
   instantiation at G = 128 (every launch checked; 32-row tiles on the
   tensor cores, 3xTF32) and prefill the flash kernel's wide one at K
   576 / V 512 (every launch the mma.sync ``float32`` form); the MoE form
   each call took (every expert
   at every decode step, grouped past 146 prompt tokens) with its device
   ms. The baseline's split-pool calls are K 576, V 512 wide
   (``mla_split_*`` keys), the engine's pool entry's 576 and 576
   (``mla_width_*``).
22. mtp — on the same weights, ``forward`` then ``mtp_hidden`` over a
   1000-token prompt on ``attn_impl="cuda"`` (flash once a layer and once
   in the MTP block) against ``"dense"``, within atol 1e-3 and rtol 1e-3,
   the dense run routed as the kernel run (the tokens it would route
   otherwise are counted); seconds of each.
23. serve_path (musicgen-large) — four codebooks at full width and depth
   (48 layers, d_model 2048, 32 heads of 64, d_ff 8192, vocab 2048;
   9.8 GB) with max_len cut to 1024 (AUDIO_MAX_LEN; 768 KiB of K/V a
   token, 13 GB an engine replica) and prompts of shape (S, 4) drawn in
   [100, 960]: the checks of phase 21 (``audio_*`` keys), the paged
   kernel at G = 1 and the DBS kernels at 768 KiB blocks, every flash
   launch ``f32_wgmma``. Then, since no fp32 path launches flash's narrow
   mma.sync form any more, one kept call holds it against its plain
   version at musicgen-large's prefill shape (32 heads, d 64,
   NARROW_MMA_PROMPT tokens) on rows of 65 fp32 values (off 16 bytes: the
   ``float32`` form), timed beside its bound and SDPA as in phase 10
   (``f32_narrow_mma_width_*`` keys).
24. train_parity — gemma2-2b at full width (d_model 2304, vocab 256000)
   cut to two layers (one local, one global; 0.75 B params), a batch of
   2 x 256 tokens, the launch plan (remat a layer, fp32, chunked
   attention): one train step's gradients on the card and on the CPU from
   the same seeded params and batch, then AdamW on the card's gradients in
   both places. Enforced (TRAIN_TOL): loss within rtol 1e-5, grad_norm
   within 1e-4, every gradient and AdamW moment within 1e-4 of its leaf's
   largest magnitude, the params after AdamW within 1e-6 of theirs; the
   errors (and the updates' own, scaled) are printed.
24b. train_parity_bf16 — the same cut, params and batch on gemma2-2b's
   own train plan (bf16 compute over fp32 params, remat a layer, chunked
   attention): one step's gradients on the card and on the CPU. Enforced:
   per parameter leaf, the card's distance to phase 24's CPU fp32
   gradient at most TRAIN16_FACTOR (1.5) times the CPU's own bf16
   gradient's (the yardstick of tests/test_torch_train_bf16.py), the
   losses within TRAIN16_LOSS_RTOL; the ratios and the card-vs-CPU
   scaled error printed.
25. train — gemma2-2b at full width and depth (26 layers, 2.61 B params,
   10.5 GB fp32) through ``Trainer`` over ``Prefetcher(SyntheticLM(...))``,
   4 x 1024 tokens a step, AdamW (warmup 2), 6 steps, logits in chunks of
   512.
   Enforced: every loss finite, the last below the first + 0.05, and
   none of the six kernels launched (the reference's training path runs no
   Pallas kernel; the kernels refuse grad). Printed: tokens/s and the
   median step over steps 2 on, the optimizer's share of a step (CUDA
   events), its byte bound, the peak memory, the model-flops share of the
   fp32 peak (6·N·tokens over step time x 67 TFLOP/s), and a profiled
   step's idle share (a "profile" line).
25b. train_bf16 — the same model, data and checks on its own plan,
   ``default_plan(cfg, ShapeSpec("train", 1024, 4, "train"),
   n_chips=1)``: 4 microbatches of one 1024-token sequence (gradients
   accumulated in fp32), remat by block, AdamW on fp32 params, bf16
   compute, logits in chunks of 1024; TRAIN16_STEPS steps. Printed as
   phase 25, with the model-flops share of the bf16 peak (989 TFLOP/s)
   and phase 25's figures beside it.
26. checkpoint — (a) a ``Trainer`` at CKPT_WIDTH (gemma2-2b's layers at
   d_model 256, 4 layers, vocab 4096: 5.0 M params, 60 MB of params and
   AdamW state a version, which the trainer's 256 MB store holds three
   of) saves every 2 steps to two replica directories; a fresh
   ``Trainer`` resumes at the same step with params and state bit-equal;
   replica 1 failed, rebuilt through ``stream_store`` and restored alone,
   bit-equal; the restored params serve through ``ServeEngine`` (``fused``)
   the live params' tokens and logits, bit for bit. (b) phase 24's params
   but the embedding table (0.62 of their 2.98 GB; the table left out for
   the script's time, CKPT_LEAVE_OUT) through a ``ReplicatedCheckpoint``
   sized for them: save (two
   replicas), restore (bit-equal) and the rebuild (every byte streamed),
   seconds and MB/s; the bytes it needs and the temp dir's free space
   first (cut to what fits, and listed, when the disk is short). (c) ``python -m
   repro_torch.launch.train --arch gemma2-2b --steps 3 --ckpt-dir <tmp>``
   as a subprocess, exit 0. Files under TMPDIR; (b)'s replicas stay for
   phase 27, then all are removed.
27. distributed — the mesh on one card: a (1, 1) ("data", "model") NCCL
   mesh over a 1-rank group (a localhost rendezvous; destroyed at the
   end). ``machine_profile()`` must name the H100 without assuming; the
   planner's placements for every parameter leaf of gemma2-2b at its
   published widths and depth, the params placed as DTensors; one decode
   step of phase 24's cut (4 prompts of 500 tokens) through
   ``make_sharded_paged_decode(mesh, True)`` against the same step through
   the local paged read (equal tokens, logits within atol 1e-5 and rtol
   1e-5), and the striped read of the first paged layer against the paged
   kernel on the same pools and block table (ATTN_TOL; kernel #4's check
   calls go in its kernels entry); phase 26's 0.62 GB checkpoint restored
   as DTensors with the planner's placements, every leaf bit-equal, with
   its MB/s; ``compressed_cross_pod_mean`` over two steps with error
   feedback and ``hierarchical_psum`` on a (1, 1, 1) ("pod", "data",
   "model") mesh, exact on one rank. The phase's seconds beside the card.
28. dryrun — (a)'s counts, started before phase 24 (below), collected
   first, so nothing runs beside (b)'s timed steps. (b)
   gemma2-2b:decode_32k at its published widths and depth on a
   (1, 1) NCCL mesh, fp32, the global batch cut to DRY_BATCH, built for
   real: ``per_device_bytes`` within 1% of the growth of
   ``torch.cuda.memory_allocated()``; one step under the counting mode
   (the paged kernel's counts zeroed just before, read just after); the
   step timed over DRY_STEPS steps with CUDA events and over DRY_OP_STEPS
   with every kernel entry routed through its custom op, in turns; the
   paged entry's host microseconds a call on both routes (the dispatch's
   cost a step); the logits finite; the stripe entry
   ``paged_attention_lse_fwd`` at the first paged layer's shapes against
   ``paged_attention_ref(..., return_lse=True)`` (out within ATTN_TOL,
   the log-sum-exp within DRY_LSE_TOL). (b') The same cell built again in
   its own default serve plan (bf16 params and compute), one step counted
   the same way: its paged launches (the bf16 form's) must be more than 0
   and equal its paged entries, its logits bf16 and finite. (a) is
   ``python -m repro_torch.launch.dryrun`` on the (16, 16) production
   mesh for gemma2-2b x train_4k and decode_32k and granite-moe-3b-a800m
   x decode_32k, and (b)'s and (b')'s cells on a fake (1, 1) world, each
   in a Python of its own on the CPU alone (its fake world never meets
   the NCCL group; with no card visible its peaks are the H100 data
   sheet's, marked assumed), started before phase 24 and running beside
   phases 24-27 (the card's and the disk's work). (c) ``python -m
   repro_torch.launch.serve --arch gemma2-2b`` runs on the card (exit 0,
   a line a request), then phase 29. Each record's counts, roofline terms
   and seconds are printed; (b)'s and (b')'s FLOPs and kernel-entry
   counts must equal their fake counts', and (b)'s ms stand beside the
   fake record's ``t_compute``, ``t_memory`` and ``bottleneck``.
29. serve_path (gemma2-2b, bf16) — after phase 28's (c): phase 9's
   model (its published widths and depth, the same seeded weights rounded
   to bf16, the serve plan's param dtype), engine and first BF16_REQUESTS
   (8) prompts of 32 new tokens (cut from 16) under ``ExecutionPlan(remat="none", attn_impl="cuda",
   compute_dtype="bfloat16")``: prefill through flash's bf16 form, decode
   through paged's pool form with bf16 q over the fp32 engine pool.
   ``_serve_traffic``'s checks and prints (tokens/s, prefill, pump and
   decode seconds, peak memory, launches, no plain call), every launch of
   the two attention kernels of their bf16 forms (``LAUNCHES_BY_DTYPE``),
   every flash launch of the wgmma form (``LAUNCHES_BY_FORM``: hd 256 in
   the model layout; its file and form in the kernel-parity line), the
   kept calls held against the plain versions in bf16 within
   BF16_ATTN_TOL (one bf16 step) and timed as in phase 10 (flash's bound
   at 989 TFLOP/s; SDPA and the paged yardstick in bf16); the split-pool
   and stripe (lse) entries on bf16 copies of the kept calls' planes;
   ``dbs_rw_read`` and ``dbs_rw_write`` in bf16 on a bf16 copy of the
   traffic's replica-0 engine pool under its kept reads and writes (bit
   for bit, timed; ``bf16_serve_width_*``).
   (b) BF16_LOCKSTEP's requests with the logits recorded on three
   engines: bf16 through the kernels, bf16 on the plain paths
   (``attn_impl="dense"``, ``kernel="ref"``: every kernel's plain
   version) and fp32 on the plain paths (the weights upcast): while a
   request's streams agree, the kernel path's largest distance to the
   fp32 logits must stay within BF16_RATIO of the plain bf16 path's
   (both compute attention in fp32 and round its output to bf16, in
   other orders), and where the two bf16 paths'
   tokens differ the plain path's top-2 margin must be under twice that
   distance. (c) The 8 requests on the plain bf16 path: tokens equal to
   the kernel path's under the TIE_MARGIN rule with that margin. Then the
   wide instantiations' bf16 forms at deepseek-v3's widths (seeded
   inputs): flash at K 576 / V 512 on BF16_WIDE_PROMPTS' lengths (every
   launch of the mma.sync bf16 form), paged on bf16 split pools (576 /
   512) and, bf16 q, over an fp32 engine pool (576) (every launch of the
   packed instantiation, ``LAUNCHES_BY_INSTANCE``; their bounds count the
   products too, at the bf16 rate and, over the fp32 pool, at two TF32
   products for q.K^T and three for P.V), each held and timed the same
   way. (d) The fork mix (BF16_FORK, before (c)'s weights are freed):
   phase 9's first 4 prompts as parents of 32 new tokens, each forked
   once right after its 8th token, each child on for 24 new tokens; first
   on the copy-based baseline (``kv_backend="host"``, its K/V pools bf16:
   the forks' CoW runs ``dbs_copy``'s bf16 form, every launch of it
   checked, a launch a pool), then on zero-copy (no ``dbs_copy``). On
   each, no plain version runs, and every parent's and child's tokens
   equal an independent decode of the parents on a second engine of the
   same backend (TIE_MARGIN rule); the two backends' tokens agree under
   (c)'s bf16 tie margin. Every kept copy is held against the plain
   version bit for bit and timed (``bf16_fork_width_*``). A
   ``serve_fork_bf16`` line: tokens/s, prefill seconds, seconds in the
   CoW copies (baseline) and the write pumps (zero-copy), launches, peak
   memory.
30. example — the four examples through their ``main`` on the card, as
   ``python -m repro_torch.examples.<name>`` runs them, at the reference
   examples' own sizes: serve_paged (gemma2-2b smoke, 10 requests over 4
   slots: no extent left), fork_sessions (granite-3-8b smoke: two forks,
   each a prefix of its parent), quickstart (granite-3-8b smoke: 15
   steps, a replicated checkpoint, a restart at step 15, 3 requests
   served); each prints its lines, its tokens/s and its launches. In each,
   the DBS write and read, paged and flash kernels must launch and no
   plain version run, and the kept calls are held against the plain
   versions on the example's own pool (phase 10's checks, its kernel-
   parity lines). train_lm (67.7M params, 8 x 256 tokens a step, bf16
   plan, checkpoints to two replicas every 50 steps and at the end) for
   EXAMPLE_TRAIN_STEPS steps (cut from 300): the loss must fall and no
   kernel launch; a restart resumes at the last step with the params and
   AdamW state bit for bit; step seconds, tokens/s, each save's MB/s
   (the store sized to the state: ``ckpt_capacity``), the resume's MB/s
   and peak memory are printed.
31. serve_path (gemma2-2b, fp16) — phase 29 on the fp16 serve plan
   (``ExecutionPlan(remat="none", attn_impl="cuda", compute_dtype=
   "float16", param_dtype="float16")``, the same seeded weights rounded to
   fp16), through the kernels' fp16 forms (one template over bf16 and
   fp16 each): (a) the 16 requests with ``_serve_traffic``'s checks, every
   flash launch ``float16`` of the wgmma form (``f16_wgmma``) and every
   paged launch ``float16_q`` (fp16 q over the fp32 engine pool), the kept
   calls, the split-pool and stripe entries on fp16 copies of their planes
   and ``dbs_rw_read``/``dbs_rw_write`` on an fp16 copy of the engine
   pool (bit for bit); (b) the lock step of 4 x 8 tokens against the plain
   fp16 and fp32 paths (every kernel-path logit finite, its distance to
   fp32 within BF16_RATIO of the plain fp16 path's); no plain 16-request
   run (phase 29's (c)); (d) the fork mix on the baseline (fp16 pools:
   every ``dbs_copy`` launch ``float16``) and on zero-copy, tokens equal
   to an independent decode; then the wide forms (flash 576 / 512 on
   mma.sync, paged split pools and the packed instantiation at G = 128)
   and flash's narrow mma.sync form at musicgen-large's d = 64 on rows one
   value off 16 bytes (NARROW_MMA_PROMPT tokens; phase 29 runs it in bf16
   too). Each fp16 form within F16_ATTN_TOL (rtol and atol 2e-3, the
   reference's tolerance for a dtype other than bf16) of its plain
   version, timed beside its bound and library call. The scan's fp16 form
   is held in phase 18 beside its bf16 one, on the kept rwkv6-3b calls.

Then a ``{"kernels": [...]}`` line (the paged and flash entries carry the
bf16 forms' numbers under ``bf16_*`` keys and their launches on phase 29's
path, by dtype and by form, and phase 28's bf16 step; the fp16 forms the
same under ``f16_*`` keys from phase 31 (the scan's from phase 18); the
DBS and scan entries their other dtypes' under ``bf16_*``, ``f16_*`` and
``uint8_*`` keys, and every entry its launches on phase 29 (d)'s and 31
(d)'s fork mixes; every entry its
launches in each example, ``launches_examples``, and the four serving
kernels their kept example calls' numbers under ``example_<name>_width_*``
keys; the paged entry the
instantiation each family's decode launched, ``launches_<family>_serve_
path_by_instance``: packed on deepseek-v3's), the ``nvidia-smi`` name/power
line, and
last ``{"ok": true, "device": {...}}``. Imports nothing of JAX or ``repro``.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
T0 = time.perf_counter()
SRC = ROOT / "src"
KERNEL_SRC = "src/repro_torch/kernels/dbs/csrc/dbs_rw.cu"
# the H100 SXM's data-sheet rates (HBM bytes/s, fp32 and 3xTF32 flops/s)
# live in repro_torch/utils/machine.py; main() imports them once it has
# found the port's sources
PAGED_SRC = "src/repro_torch/kernels/paged_attention/csrc/paged_attention.cu"
FLASH_SRC = "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu"
FLASH_WGMMA_SRC = ("src/repro_torch/kernels/flash_attention/csrc/"
                   "flash_attention_wgmma.cu")
FLASH_WGMMA_F32_SRC = ("src/repro_torch/kernels/flash_attention/csrc/"
                       "flash_attention_wgmma_f32.cu")
COPY_SRC = "src/repro_torch/kernels/dbs/csrc/dbs_copy.cu"
RWKV_SRC = "src/repro_torch/kernels/rwkv6_scan/csrc/rwkv6_scan.cu"
RWKV_MODEL, RWKV_CHUNK = "rwkv6-3b", 64
RWKV_REF_CHUNK = 256             # the reference's chunk rule (BlockCtx)
RWKV_KEEP_LAYERS = 4             # layers kept of each kept decode step
# rtol 1e-4 and atol 1e-4, widened to 1e-5 of the reference's largest
# magnitude: over a long prompt with little decay the outputs grow to
# hundreds, and fp32 rounding alone then moves an element near zero by a
# few 1e-4 (the plain versions themselves differ from an fp64 oracle by up
# to 3.4e-4 at 1000 tokens of magnitude 500 on a CPU)
RWKV_RTOL, RWKV_ATOL, RWKV_ATOL_SCALE = 1e-4, 1e-4, 1e-5
SERVE_MODEL, SERVE_REQUESTS, SERVE_NEW = "gemma2-2b", 16, 32
SERVE_PROMPT = (100, 1000)       # prompt lengths drawn in [lo, hi]
SERVE_KEEP_STEPS = (8, 24, 40)   # decode steps whose paged calls are kept
PROFILE_STEPS = 4                # decode steps timed, then profiled
ATTN_TOL = dict(atol=1e-4, rtol=1e-4)
# a bf16 form against its plain version in the working type: both compute
# in fp32 from the same bf16 inputs and round once, so they differ by one
# bf16 step (at most 2^-7 of the value) where the two land on either side
# of a rounding boundary; the atol is ATTN_TOL's, for values near zero
BF16_ATTN_TOL = dict(atol=1e-4, rtol=2 ** -7)
# an fp16 form against its plain version: the reference's own tolerance for
# a dtype other than bf16 (tests/test_kernels.py _tol), which one fp16 step
# (2^-10 of the value) fits
F16_ATTN_TOL = dict(atol=2e-3, rtol=2e-3)
HOST_TOL = dict(atol=1e-3, rtol=1e-3)   # host baseline vs zero-copy logits
TIE_MARGIN = 1e-2                # a closer top-2 step may pick either token
BLOCK, PAGE_BLOCKS, REPLICAS, BATCH = 4096, 32, 3, 64
# the trace; N_OPS sets the random-I/O phases (cut from 12000 to 8000 for
# the script's time: every full-trace phase runs two thirds of the ops
# over the same 1 GiB volume)
SEED, N_OPS = 0, 8000
LADDER = [("fused", "cuda"), ("fused", "copy"), ("slots", "torch")]
LADDER_OPS = N_OPS // 16         # the ladder's cut trace (about 3k ops)
LOOP_OPS, LOOP_MAX_OPS = 600, 300
READ_SAMPLE_EVERY, READ_SAMPLES = 128, 32
READ_SERVE_EVERY = 8             # of the zero-copy serve path's write pumps
COPY_SAMPLE_EVERY = 8            # of the copy column's dbs_copy calls
# the controller slice: the ladder's first three columns on the byte API
# (the per-request ones on the loop column's cut), the paper's layer rows
# on the request API, the replication policy matrix, the snapshot chain
CONTROLLER_LADDER = [
    ("upstream", dict(backend="upstream", kernel="torch"), True),
    ("+frontend", dict(backend="loop", storage="chained", kernel="torch"),
     True),
    ("+comm", dict(backend="slots", storage="chained", kernel="torch"),
     False)]
LAYER_COLUMNS = ("upstream", "+frontend", "+comm", "+dbs", "+fused",
                 "+sharded", "+ring")
LAYER_ROWS = ("frontend_only", "without_storage", "full_engine")
PER_REQUEST_COLUMNS = ("upstream", "+frontend")
LAYER_OPS = {False: 2048, True: 300}   # a round: batched, per-request
SIMNET = dict(transport="simnet",
              transport_opts=dict(latency=[1, 1, 6], window=8))
REPLICATION = [
    ("local/all", dict(n_replicas=2)),
    ("simnet/all", dict(n_replicas=3, write_policy="all", **SIMNET)),
    ("simnet/quorum", dict(n_replicas=3, write_policy="quorum", **SIMNET)),
    ("simnet/async", dict(n_replicas=3, write_policy="async", **SIMNET)),
    ("simnet/quorum+latreads", dict(n_replicas=3, write_policy="quorum",
                                    read_policy="latency", **SIMNET))]
SNAP_DEPTHS, SNAP_READS = (0, 4, 16, 64), 256   # reads a round
SNAP_VOLUMES = 32                # twice the main path's: 128 snapshot slots
MIN_WINDOW_S = 0.25              # each controller-phase timing, at least
                                 # (0.5 s until cut for the script's time)
# the shards slice: the byte API on S stacked shards (one volume a shard)
# at the main path's total extents, Table III's shard counts and volumes,
# and sharded serving on two KV shards
SHARDS, FAILED_SHARD = 4, 1
SHARDED_SAMPLE_EVERY = 16        # of the sharded pool's pumps: kernel inputs
DENSE_READ_CALLS = 8             # dense S*B-lane reads over the offset rows
SPLIT_CALLS = 200                # calls a part of the S=1 pump, timed
TABLE3_SHARDS, TABLE3_VOLUMES = (1, 2, 4, 8), 8
SERVE_SHARDS, SERVE_REBUILD_REQUESTS = 2, 4
SERVE_RING_REQUESTS = 4          # ring serving: phase 9's first requests
# the durability slice: the journal's write stream, the reference's gate
# (benchmarks/ladder.py check_durability_gate: at most 30% overhead),
# the ring's journaled stream, and the tier's pages and device budget
DUR_WRITES, DUR_FLUSH_EVERY, DUR_GATE_FLOOR = 4096, 64, 0.77
RING_DUR_WRITES = 2048           # the ring's stream, cut for time
TIER_PAGES, TIER_BUDGET = 512, 256   # of 8192 pages: cut for time
# the harness slice: the chaos catalog on the card against the CPU at the
# catalog's own geometry (cut to HARNESS_AB_OPS ops a scenario), then at
# the block device's widths over the main path's pool, the volume cut to
# HARNESS_PAGES pages (8 MiB: the end-of-trace sweeps read every volume
# and clone whole through the byte API, once a replica), each scenario at
# its own op count
HARNESS_AB_OPS, HARNESS_PAGES = 60, 64
HARNESS_LINKS_OFF = (("straggler", 0.0), ("heal", 0.0), ("drop_on", 0.0),
                     ("drop_off", 0.0))
# run() calls beside the catalog: the main path's backend on the cuda and
# copy entries, and the default backend at one shard, on the chaos/simnet
# trace with ten events (no simnet links on these backends)
HARNESS_EXTRA = (("fused/cuda", dict(backend="fused", kernel="cuda")),
                 ("fused/copy", dict(backend="fused", kernel="copy")),
                 ("ring/s1", dict(backend="ring", n_shards=1,
                                  kernel="auto")))


# the hybrid and MoE families, served at full width after rwkv6-3b: hymba
# (hybrid heads: attention and Mamba side by side) with two prompts past
# its 1024-token window and one of 513 tokens, a length the reference's
# Mamba prefill rejects; granite-moe (40 experts, top 8)
HYBRID_MODEL, MOE_MODEL = "hymba-1.5b", "granite-moe-3b-a800m"
HYBRID_LONG = (1100, 1500)       # prompt lengths past the window, [lo, hi]
HYBRID_AT = {2: "long", 6: "513", 10: "long"}   # request index -> length
FAMILY_KEEP_LAYERS = 4           # paged calls kept of each kept step
# phases 21-23: deepseek-v3 (MLA, 256 experts, the MTP head) cut to its
# three dense layers and its first MoE layer (63 GB of fp32 weights; five
# layers would take 106 GB), and musicgen-large (four codebooks, 768 KiB of
# K/V a token) at max_len 1024, prompts of [100, 960] tokens
MLA_MODEL, MLA_LAYERS = "deepseek-v3-671b", 4
AUDIO_MODEL, AUDIO_MAX_LEN, AUDIO_PROMPT = "musicgen-large", 1024, (100, 960)
MTP_PROMPT = 1000                # tokens of the MTP check's prompt
FAMILY_HELD_BYTES = 2 << 30      # what may stay allocated before a phase
# phases 24-26, training and checkpoints: gemma2-2b at full width; the
# parity step cut to two layers (one local, one global) at 2 x 256 tokens,
# the train phase at full depth, 4 x 1024 tokens a step, 6 steps, logits in
# chunks of 512; the checkpoint phase's trainer at a width whose params and
# AdamW state (~60 MB a version, three versions in flight) fit the
# trainer's 256 MB store, then the parity cut's params (~3 GB)
TRAIN_MODEL = "gemma2-2b"
PARITY_LAYERS, PARITY_BATCH, PARITY_SEQ = 2, 2, 256
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_WARMUP = 4, 1024, 6, 2
TRAIN_CHUNK = 512
# phases 24b-25b, gemma2-2b's own train plan (bf16 compute over fp32
# params): phase 24's cut, card against CPU, held to the CPU's own bf16
# error (tests/test_torch_train_bf16.py's yardstick: there the port's bf16
# gradients lie at most 1.28x as far from fp32's as the reference's own
# bf16 ones); the losses within twice the largest bf16 loss difference
# measured between the packages on the CPU (8.1e-5 at train_lm's width);
# then TRAIN16_STEPS steps at full width and depth
TRAIN16_FACTOR = 1.5
TRAIN16_LOSS_RTOL = 2e-4
TRAIN16_STEPS = 6
# phase 30, the examples: run as a user runs them on the card; train_lm cut
# from its 300 steps to EXAMPLE_TRAIN_STEPS (it checkpoints every 50)
EXAMPLE_TRAIN_STEPS = 100
EXAMPLE_KEEP_PAGED = 16          # paged calls kept, every EXAMPLE_EVERY-th
EXAMPLE_EVERY = 5                # of the paged calls and the pumps
# card against CPU, fp32 both (TF32 off): the loss and the global norm
# relative; every gradient, the AdamW moments and the params after AdamW
# within a share of their leaf's largest magnitude (an update is ~lr =
# 1.5e-4 and lands on params of up to ~0.1, so one rounding of a param is
# ~5e-5 of the update, and a param that lands near 0 has no relative
# accuracy: the updates' own scaled error is printed, not held)
TRAIN_TOL = dict(loss_rtol=1e-5, grad_norm_rtol=1e-4, grad_scaled=1e-4,
                 adamw_state_scaled=1e-4, adamw_params_scaled=1e-6)
CKPT_WIDTH = dict(n_layers=4, d_model=256, n_heads=4, n_kv_heads=2,
                  head_dim=64, d_ff=1024, vocab_size=4096)
CKPT_EVERY, CKPT_STEPS = 2, 4
# phase 26 (b) checkpoints phase 24's params but these (cut for the
# script's time: the table is 2.36 of the 2.98 GB; 0.62 GB remain)
CKPT_LEAVE_OUT = ("embed",)
# phase 27, the mesh on one card: a (1, 1) NCCL mesh; the striped decode
# on phase 24's cut (a batch of DIST_BATCH prompts of DIST_PROMPT tokens,
# caches of DIST_MAX_LEN positions), held against the local paged read
DIST_BATCH, DIST_PROMPT, DIST_MAX_LEN = 4, 500, 1024
DIST_TOL = dict(atol=1e-5, rtol=1e-5)
# phase 28, the dry run: (a) the production cells counted on a fake (16, 16)
# world, each in a Python of its own started in the background before phase
# 25 and collected before (b) (they need no card); (b) DRY_MODEL:decode_32k at its
# published widths and depth built for real on a (1, 1) NCCL mesh, in fp32
# (DRY_PLAN) and then in the cell's own bf16 serve plan, the global batch
# 128 cut to DRY_BATCH (fp32 params 10.5 GB + 8 x 3.9 GB of caches at 32k:
# ~42 GB, about half the card; half that in bf16)
DRY_CELLS = (("gemma2-2b", "train_4k"), ("gemma2-2b", "decode_32k"),
             ("granite-moe-3b-a800m", "decode_32k"))
DRY_MODEL, DRY_BATCH = "gemma2-2b", 8
DRY_PLAN = {"compute_dtype": "float32", "param_dtype": "float32"}
DRY_STEPS = 10                   # timed steps, direct entries, and with
DRY_OP_STEPS = 6                 # the entries through their ops (cut from
                                 # 20 and 10 for the script's time)
DRY_MEM_TOL = 0.01               # per_device_bytes vs the allocator's growth
DRY_LSE_TOL = dict(atol=1e-5, rtol=1e-5)   # the stripe entry's log-sum-exp
DRY_TIMEOUT = 900
BF16_RATIO = 1.5                 # kernel bf16 vs fp32 logits / plain bf16's
# phase 29's (a) and (c) on phase 9's first 8 requests (cut from 16 for
# the script's time once phase 31 served the 16 on the fp16 plan)
BF16_REQUESTS = 8
BF16_LOCKSTEP = (4, 8)           # requests, new tokens of phase 29's (b)
BF16_WIDE_PROMPTS = (479, 884)   # MLA prefill lengths of the wide forms
NARROW_MMA_PROMPT = 700          # musicgen-large's prefill, the mma form
# phase 29's fork mix: parents (phase 9's first prompts), their new tokens,
# the token after which each forks once, and each child's new tokens
BF16_FORK = (4, 32, 8, 24)


def emit(**kw) -> None:
    """One JSON line; ``t_s`` is the script's wall time when it was
    printed."""
    print(json.dumps({**kw, "t_s": time.perf_counter() - T0}), flush=True)


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# phase 3: the write kernel's parity and timing at full width
# ---------------------------------------------------------------------------
def parity_batches(torch, dbs, route, dev, n_extents, max_pages, rng,
                   n_batches=16, hold_extent0=False):
    """Routed write batches from a seeded write_pages trace on the card:
    holes first, then (after a snapshot and a clone) a mix of CoW pages,
    in-place pages, holes, duplicate (page, block) lanes and masked lanes.
    With ``hold_extent0`` the free ring hands extent 0 out last until the
    first CoW batch, whose lane 0 is a CoW lane and takes it: a live copy
    into extent 0 beside masked lanes with dst -1. Returns a list of
    (*route(ops, ...), payload, n_live, n_cow)."""
    import numpy as np
    st = dbs.make_state(n_extents, 16, max_pages, device=dev)
    if hold_extent0:
        st.free.ids = torch.roll(st.free.ids, -1)     # extent 0 last
    st, _ = dbs.create_volume(st)
    pre, post = set(), set()           # pages of vol 0 before/after snapshot
    out = []
    gen = torch.Generator(device=dev).manual_seed(int(rng.integers(1 << 30)))
    for i in range(n_batches):
        if i == 2:
            st, _ = dbs.snapshot(st, 0)
            st, _ = dbs.clone(st, 0)   # volume 1 shares every page of 0
            if hold_extent0:           # extent 0 to the head of the ring
                n = st.free.capacity
                h, t = int(st.free.head) % n, (int(st.free.tail) - 1) % n
                ids = st.free.ids.clone()
                ids[[h, t]] = ids[[t, h]]
                st.free.ids = ids
        vols = np.zeros(BATCH, np.int32)
        pages = rng.integers(0, max_pages, BATCH).astype(np.int32)
        if i >= 2:
            kind = rng.integers(0, 3, BATCH)          # 0 CoW, 1 in place, 2 hole
            if hold_extent0 and i == 2:
                kind[0] = 0
            old, new = sorted(pre), sorted(post)
            for j in range(BATCH):
                if kind[j] == 0 and old:
                    vols[j] = rng.integers(0, 2)
                    pages[j] = old[rng.integers(len(old))]
                elif kind[j] == 1 and new:
                    pages[j] = new[rng.integers(len(new))]
        blocks = rng.integers(0, PAGE_BLOCKS, BATCH).astype(np.int64)
        first = 1 if hold_extent0 and i == 2 else 0   # lane 0 leads alone
        dup = rng.choice(BATCH - first, 8, replace=False) + first
        vols[dup[4:]], pages[dup[4:]] = vols[dup[:4]], pages[dup[:4]]
        blocks[dup[6:]] = blocks[dup[4:6]] = blocks[dup[:2]]
        mask = rng.random(BATCH) < 0.9
        mask[:first] = True
        tb = torch.from_numpy(blocks).to(dev)
        st, ops = dbs.write_pages(
            st, torch.from_numpy(vols).to(dev), torch.from_numpy(pages).to(dev),
            torch.ones((), dtype=torch.int64, device=dev) << tb,
            torch.from_numpy(mask).to(dev))
        routed = route(ops, PAGE_BLOCKS, tb, n_extents)
        ok = ops.ok.cpu().numpy()
        for j in np.nonzero(ok & (vols == 0))[0]:
            (pre if i < 2 else post).add(int(pages[j]))
        n_live = int(ok.sum())
        n_cow = int((ops.cow_src >= 0).sum())
        payload = torch.rand((BATCH, BLOCK), generator=gen, device=dev)
        out.append((*routed, payload, n_live, n_cow))
    return out


def _bytes_equal(torch, a, b) -> bool:
    """Equal bit for bit (as bytes: any dtype, NaN patterns included)."""
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8))


def dtype_name(dtype) -> str:
    """"bfloat16" for torch.bfloat16: the dtype keys of the lines."""
    return str(dtype).split(".")[1]


def _max_err(torch, a, b) -> float:
    """The largest absolute difference of two tensors of any dtype, as
    fp32, taken in slices of the first dimension of at most 2**26 elements
    (a pool of several GB needs no fp32 copy of itself); 0.0 when empty."""
    if a.numel() == 0:
        return 0.0
    rows = max(1, (1 << 26) // max(1, a[0].numel()))
    return max(float((x.float() - y.float()).abs().max())
               for x, y in zip(a.split(rows), b.split(rows)))


def resources(torch, info, grid_blocks=None):
    """A kernel's registers and shared memory per block (``info``, from
    cudaFuncGetAttributes) and its blocks in flight: the grid's blocks (by
    default ``info["grid_blocks"]``, for a kernel that sizes its grid per
    call), at most its resident blocks per SM on every SM of the card."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    if grid_blocks is None:
        grid_blocks = info["grid_blocks"]
    return {**info, "sms": sms, "grid_blocks": grid_blocks,
            "blocks_in_flight": min(grid_blocks,
                                    info["blocks_per_sm"] * sms)}


def phase_write_kernel(torch, args, dev):
    import numpy as np
    from repro_torch.core import dbs
    from repro_torch.kernels.dbs import (dbs_rw_write, dbs_rw_write_ref,
                                         dbs_write_bytes)
    from repro_torch.kernels.dbs.ops import _route_writes
    from repro_torch.kernels.dbs.rw_kernel import write_info
    from repro_torch.kernels.timing import graph_ms
    rng = np.random.default_rng(SEED)
    n_e = args.n_extents
    batches = parity_batches(torch, dbs, _route_writes, dev, n_e,
                             args.max_pages, rng)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    pool = torch.rand((n_e + 1, PAGE_BLOCKS, BLOCK), generator=gen,
                      device=dev)
    plain = pool.clone()
    for src, dst, lane_of, pay, _, _ in batches:
        dbs_rw_write(pool, src, dst, lane_of, pay, check_routing=True)
        dbs_rw_write_ref(plain, src, dst, lane_of, pay)
    torch.cuda.synchronize()
    w_err = float((pool - plain).abs().max())
    if not torch.equal(pool, plain):
        raise AssertionError(f"dbs_rw_write differs from its plain version "
                             f"(max abs err {w_err})")
    w_bytes = [dbs_write_bytes(nl, nc, PAGE_BLOCKS, BLOCK, 4)
               for *_, nl, nc in batches]
    # thread blocks per batch that copy a block (the rest return at once)
    copying = [int(((dst != n_e)[:, None] & ((lane_of >= 0)
                                               | (src != dst)[:, None]))
                   .sum()) for src, dst, lane_of, *_ in batches]
    # the library yardstick: index_copy_ of the composed live rows, whole
    # 512 KiB rows for every live lane (more bytes than the kernel moves)
    composed = []
    for src, dst, lane_of, pay, _, _ in batches:
        live = (dst != n_e).nonzero().flatten()
        composed.append((dst[live].long(), plain[dst[live].long()].clone()))
    n = len(batches)
    w_ms = graph_ms(lambda: [dbs_rw_write(pool, s, d, lo, p)
                                    for s, d, lo, p, _, _ in batches], n)
    w_plain = graph_ms(lambda: [dbs_rw_write_ref(plain, s, d, lo, p)
                                       for s, d, lo, p, _, _ in batches], n)
    w_lib = graph_ms(lambda: [plain.index_copy_(0, i, v)
                                     for i, v in composed], n)
    del composed
    emit(phase="kernel_parity", kernel="dbs_rw_write",
         pool_shape=list(pool.shape), lanes=BATCH, batches=n,
         live_lanes=[b[4] for b in batches],
         cow_lanes=[b[5] for b in batches], equal=True)
    del plain
    # the other dtypes: bf16 and uint8 copies of the pool and the payloads
    # (uint8: the [0, 1) floats scaled to bytes), the same batches
    forms = {}
    for dt in (torch.bfloat16, torch.uint8):
        conv = ((lambda t, dt=dt: t.to(dt)) if dt.is_floating_point
                else (lambda t, dt=dt: (t * 256).to(dt)))
        got = write_parity(torch, conv(pool), [
            (s_, d_, lo, conv(p_)) for s_, d_, lo, p_, _, _ in batches])
        forms[dtype_name(dt)] = got
        emit(phase="kernel_parity", kernel="dbs_rw_write",
             dtype=dtype_name(dt), width="block device",
             pool_shape=list(pool.shape), batches=n, equal=True,
             **{k: got[k] for k in ("max_abs_err", "ms", "plain_ms",
                                    "bound_ms", "library_ms",
                                    "bytes_per_call", "resources")})
        torch.cuda.empty_cache()
    del pool
    torch.cuda.empty_cache()
    mean_wb = sum(w_bytes) / len(w_bytes)
    return {"name": "dbs_rw_write", "route": "cuda", "source": KERNEL_SRC,
            "replaces": "src/repro/kernels/dbs/rw_kernel.py:42",
            "max_abs_err": w_err, "ms": w_ms, "plain_ms": w_plain,
            "bound_ms": mean_wb / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "library_ms": w_lib, "bytes_per_batch": mean_wb,
            **resources(torch, write_info(16), PAGE_BLOCKS * BATCH),
            "copying_blocks_per_batch": sum(copying) / n,
            **_width_keys("bf16_block", forms["bfloat16"]),
            **_width_keys("uint8_block", forms["uint8"])}


# ---------------------------------------------------------------------------
# phase 4: the copy kernel's parity and timing at the block device's width
# ---------------------------------------------------------------------------
def copy_parity(torch, pool, calls, timed=True):
    """Hold ``dbs_copy`` against ``dbs_copy_ref`` bit for bit on ``calls``
    ((src, dst, mask) over the (E, page, D) ``pool``, applied in turn to
    ``pool`` and a copy of it); with ``timed``, then time one pass over the
    calls (kernel, plain version, and ``index_copy_`` of each call's live
    source rows, gathered beforehand: the bytes the kernel moves) on
    ``pool``. Returns the numbers per call."""
    from repro_torch.kernels._build import word_bytes
    from repro_torch.kernels.dbs import dbs_copy, dbs_copy_bytes, dbs_copy_ref
    from repro_torch.kernels.dbs.copy_kernel import copy_info
    from repro_torch.kernels.timing import graph_ms
    _e, page, d = pool.shape
    size = pool.element_size()
    plain = pool.clone()
    copied, lib_in = [], []
    for src, dst, mask in calls:
        dbs_copy(pool, src, dst, mask, check_routing=True)
        dbs_copy_ref(plain, src, dst, mask)
        live = (mask.bool() & (src >= 0) & (dst >= 0) & (src != dst)
                ).nonzero().flatten()
        copied.append(int(live.numel()))
        lib_in.append((dst[live].long(), plain[src[live].long()].clone()))
    torch.cuda.synchronize()
    err = _max_err(torch, pool, plain)
    if not _bytes_equal(torch, pool, plain):
        raise AssertionError(f"dbs_copy differs from its plain version "
                             f"(max abs err {err})")
    if not timed:
        return {"max_abs_err": err, "rows_copied": copied}
    n = len(calls)
    ms = graph_ms(lambda: [dbs_copy(pool, s, d, m)
                                  for s, d, m in calls], n)
    plain_ms = graph_ms(lambda: [dbs_copy_ref(plain, s, d, m)
                                        for s, d, m in calls], n)
    lib = graph_ms(lambda: [plain.index_copy_(0, i, v)
                                   for i, v in lib_in], n)
    del plain, lib_in
    mean_b = sum(dbs_copy_bytes(c, page, d, size) for c in copied) / n
    row_bytes = page * d * size
    word = word_bytes(row_bytes, pool)
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": mean_b / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "library_ms": lib, "bytes_per_call": mean_b, "calls": n,
            "rows_copied": copied,
            "zero_row_calls": sum(c == 0 for c in copied) / n,
            "resources": {"lanes": calls[0][0].numel(), "word_bytes": word,
                          **resources(torch, copy_info(
                              calls[0][0].numel(), row_bytes, word))}}


def phase_copy_kernel(torch, args, dev):
    """``dbs_copy``'s parity at the block device's width (pool (E+1, 32,
    4096) f32, 512 KiB rows) on CoW batches from the port's own
    ``write_pages`` (``cow_src``, ``dst``, ``cow_src >= 0``): live CoW
    lanes, hole and in-place lanes masked with their dst, masked lanes with
    dst -1, and a live copy into extent 0. These batches copy far more rows
    than the block device's own path does, so they are not timed: phase 8
    times the kernel on calls kept from the ``copy`` column."""
    import numpy as np
    from repro_torch.core import dbs
    rng = np.random.default_rng(SEED + 5)
    n_e = args.n_extents
    batches = parity_batches(
        torch, dbs, lambda ops, *_: (ops.cow_src, ops.dst,
                                     ops.cow_src >= 0),
        dev, n_e, args.max_pages, rng, hold_extent0=True)
    calls = [b[:3] for b in batches]
    del batches
    into0 = sum(int(((d == 0) & m).sum()) for _, d, m in calls)
    masked_null = sum(int(((d < 0) & ~m).sum()) for _, d, m in calls)
    if not into0 or not masked_null:
        raise AssertionError("the copy batches hold no live copy into "
                             "extent 0 beside masked dst -1 lanes")
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    pool = torch.rand((n_e + 1, PAGE_BLOCKS, BLOCK), generator=gen,
                      device=dev)
    got = copy_parity(torch, pool, calls, timed=False)
    emit(phase="kernel_parity", kernel="dbs_copy", width="block device",
         inputs="crafted write_pages batches", pool_shape=list(pool.shape),
         lanes=BATCH, batches=len(calls), rows_copied=got["rows_copied"],
         live_copies_into_extent0=into0, masked_null_lanes=masked_null,
         max_abs_err=got["max_abs_err"], equal=True)
    del pool
    torch.cuda.empty_cache()
    return got["max_abs_err"]


def phase_copy_kernel_main(torch, mgr, calls):
    """Parity and timing of ``dbs_copy`` on the (src, dst, mask) calls kept
    from the ``copy`` column's own run, over replica 0's pool: the load the
    block device really gives the kernel (most write steps copy no row)."""
    if not calls:
        raise AssertionError("no dbs_copy inputs were kept on the block "
                             "device")
    pool0 = mgr.engine.backend.replicas[0].pool
    pool = pool0.view(pool0.shape[0], PAGE_BLOCKS, -1)
    got = copy_parity(torch, pool, calls)
    emit(phase="kernel_parity", kernel="dbs_copy", width="block device",
         inputs="kept from the copy column", pool_shape=list(pool.shape),
         lanes=BATCH, calls=len(calls), rows_copied=got["rows_copied"],
         rows_per_call=sum(got["rows_copied"]) / len(calls), equal=True)
    return {"name": "dbs_copy", "route": "cuda", "source": COPY_SRC,
            "replaces": "src/repro/kernels/dbs/copy_kernel.py:25",
            "max_abs_err": got["max_abs_err"], "ms": got["ms"],
            "plain_ms": got["plain_ms"], "bound_ms": got["bound_ms"],
            "bound_by": "bytes", "library_ms": got["library_ms"],
            "library_call": "index_copy_ of the live lanes' source rows, "
                            "gathered beforehand",
            "bytes_per_call": got["bytes_per_call"],
            "rows_per_call": sum(got["rows_copied"]) / len(calls),
            "zero_row_calls": got["zero_row_calls"], **got["resources"]}


# ---------------------------------------------------------------------------
# phase 6: the read kernel on the main path's own inputs
# ---------------------------------------------------------------------------
def read_parity(torch, pool, reads):
    """Hold ``dbs_rw_read`` against ``dbs_rw_read_ref`` bit for bit on the
    kept (ext, block) batches over the (E, page, D) ``pool``, then time one
    pass over them as in phase 3 (kernel, plain version, and
    ``index_select`` of the same blocks). A hole lane stores one zero block
    and loads nothing, so the bound counts it at one block; a mapped lane
    reads and writes one. Returns the numbers per batch."""
    from repro_torch.kernels._build import word_bytes
    from repro_torch.kernels.dbs import (dbs_read_bytes, dbs_rw_read,
                                         dbs_rw_read_ref)
    from repro_torch.kernels.dbs.rw_kernel import read_info
    from repro_torch.kernels.timing import graph_ms
    _e, page, d = pool.shape
    size = pool.element_size()
    err = 0.0
    holes, lanes = [], []
    for ext, blk in reads:
        got, want = dbs_rw_read(pool, ext, blk), dbs_rw_read_ref(pool, ext, blk)
        err = max(err, _max_err(torch, got, want))
        if got.dtype != pool.dtype or not _bytes_equal(torch, got, want):
            raise AssertionError("dbs_rw_read differs from its plain version")
        holes.append(int((ext < 0).sum()))
        lanes.append(int(ext.numel()))
    n = len(reads)
    flat = pool.view(-1, d)
    idx = [(ext.clamp(min=0).long() * page + blk.long())
           for ext, blk in reads]
    ms = graph_ms(lambda: [dbs_rw_read(pool, e, b)
                                  for e, b in reads], n)
    plain = graph_ms(lambda: [dbs_rw_read_ref(pool, e, b)
                                     for e, b in reads], n)
    lib = graph_ms(lambda: [flat.index_select(0, i) for i in idx], n)
    mean_b = sum(dbs_read_bytes(b - h, d, size) + h * d * size
                 for b, h in zip(lanes, holes)) / n
    common = max(set(lanes), key=lanes.count)
    word = word_bytes(d * size, pool)
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain,
            "bound_ms": mean_b / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "library_ms": lib, "bytes_per_call": mean_b, "calls": n,
            "hole_lanes": holes,
            "lanes": lanes,
            "resources": {"lanes": common, "word_bytes": word, **resources(
                torch, read_info(common, d * size, word))}}


def _attn_tol(torch, dtype):
    """The attention kernels' tolerance against their plain versions in
    ``dtype``: ATTN_TOL in fp32, BF16_ATTN_TOL in bf16, F16_ATTN_TOL in
    fp16."""
    return {torch.float32: ATTN_TOL, torch.bfloat16: BF16_ATTN_TOL}.get(
        dtype, F16_ATTN_TOL)


def _tag16(torch, dtype) -> str:
    """A 16-bit dtype's form prefix (``LAUNCHES_BY_FORM``, the kernels
    line's keys): bf16 or f16."""
    return "bf16" if dtype == torch.bfloat16 else "f16"


def _width_keys(tag, k):
    """A kernel-parity result under ``<tag>_width_*`` keys of an entry."""
    keep = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "max_abs_err", "bytes_per_call", "flops_per_call", "splits",
            "grid_blocks_per_call", "calls", "resources", "source", "form",
            "instance")
    return {f"{tag}_width_{key}": k[key] for key in keep if key in k}


def write_parity(torch, pool, writes):
    """Apply the kept (src, dst, lane_of, payload) write calls in turn to
    the (E, page, D) ``pool`` (updated in place) through ``dbs_rw_write``
    and to a copy of it through ``dbs_rw_write_ref``: equal bit for bit.
    Then time one pass over them as in phase 3 (kernel, plain version, and
    ``index_copy_`` of the composed live rows, which moves whole rows).
    Returns the numbers per call."""
    from repro_torch.kernels._build import word_bytes
    from repro_torch.kernels.dbs import (dbs_rw_write, dbs_rw_write_ref,
                                         dbs_write_bytes)
    from repro_torch.kernels.dbs.rw_kernel import write_info
    from repro_torch.kernels.timing import graph_ms
    _e, page, d = pool.shape
    size = pool.element_size()
    dump = pool.shape[0] - 1
    plain = pool.clone()
    touched = set()
    for src, dst, lane_of, pay in writes:
        dbs_rw_write(pool, src, dst, lane_of, pay, check_routing=True)
        dbs_rw_write_ref(plain, src, dst, lane_of, pay)
        touched.update(dst[dst != dump].tolist())
    torch.cuda.synchronize()
    rows = torch.tensor(sorted(touched), dtype=torch.int64, device=pool.device)
    # 16 rows at a time: musicgen's rows are 24 MiB each
    err = max((_max_err(torch, pool[r], plain[r]) for r in rows.split(16)),
              default=0.0)
    if not _bytes_equal(torch, pool, plain):
        raise AssertionError(f"dbs_rw_write differs from its plain version "
                             f"(max abs err {err})")
    n = len(writes)
    n_bytes, composed = [], []
    for src, dst, lane_of, _pay in writes:
        live = dst != dump
        n_bytes.append(dbs_write_bytes(int((lane_of >= 0).sum()),
                                       int((live & (src != dst)).sum()),
                                       page, d, size))
        idx = dst[live].long()
        composed.append((idx, plain[idx].clone()))
    ms = graph_ms(lambda: [dbs_rw_write(pool, s_, d_, lo, p_)
                           for s_, d_, lo, p_ in writes], n)
    plain_ms = graph_ms(lambda: [dbs_rw_write_ref(plain, s_, d_, lo, p_)
                                 for s_, d_, lo, p_ in writes], n)
    lib = graph_ms(lambda: [plain.index_copy_(0, i, v)
                            for i, v in composed], n)
    del composed, plain
    lanes = [int(w[0].numel()) for w in writes]
    common = max(set(lanes), key=lanes.count)
    mean_b = sum(n_bytes) / n
    word = word_bytes(d * size, pool, writes[0][3])
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": mean_b / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "library_ms": lib, "bytes_per_call": mean_b, "calls": n,
            "lanes": lanes, "rows_written": len(touched),
            "resources": {"lanes": common, "word_bytes": word, **resources(
                torch, write_info(word), page * common)}}


def phase_read_kernel(torch, mgr, reads):
    """Parity and timing of dbs_rw_read on the (ext, block) batches kept
    from the main path, over replica 0's pool (all replicas agree)."""
    if not reads:
        raise AssertionError("no read-kernel inputs were kept")
    pool0 = mgr.engine.backend.replicas[0].pool
    pool = pool0.view(pool0.shape[0], PAGE_BLOCKS, -1)
    got = read_parity(torch, pool, reads)
    n, holes = len(reads), got["hole_lanes"]
    emit(phase="kernel_parity", kernel="dbs_rw_read",
         pool_shape=list(pool.shape), lanes=BATCH, batches=n,
         hole_lanes=holes, hole_share=sum(holes) / (n * BATCH), equal=True)
    # the other dtypes: bf16 and uint8 copies of the pool (its fp32 lanes
    # carry one byte each, so both copies are exact), the same batches
    forms = {}
    for dt in (torch.bfloat16, torch.uint8):
        copy = pool.to(dt)
        forms[dtype_name(dt)] = f = read_parity(torch, copy, reads)
        emit(phase="kernel_parity", kernel="dbs_rw_read",
             dtype=dtype_name(dt), width="block device",
             pool_shape=list(copy.shape), batches=n, equal=True,
             **{k: f[k] for k in ("max_abs_err", "ms", "plain_ms",
                                  "bound_ms", "library_ms", "bytes_per_call",
                                  "resources")})
        del copy
        torch.cuda.empty_cache()
    return {"name": "dbs_rw_read", "route": "cuda", "source": KERNEL_SRC,
            "replaces": "src/repro/kernels/dbs/rw_kernel.py:78",
            "max_abs_err": got["max_abs_err"], "ms": got["ms"],
            "plain_ms": got["plain_ms"], "bound_ms": got["bound_ms"],
            "bound_by": "bytes", "library_ms": got["library_ms"],
            "library_call": "index_select of the same blocks",
            "bytes_per_batch": got["bytes_per_call"], **got["resources"],
            **_width_keys("bf16_block", forms["bfloat16"]),
            **_width_keys("uint8_block", forms["uint8"])}


def phase_read_kernel_serve(torch, eng, reads):
    """Parity and timing of dbs_rw_read at the zero-copy serving width, on
    the (ext, block) batches kept from every READ_SERVE_EVERY-th write pump
    of the serve path's traffic, over its own replica-0 pool ((E+1, 32,
    26624) f32: one 104 KiB block a token)."""
    if not reads:
        raise AssertionError("no read-kernel inputs were kept on the serve "
                             "path")
    pool0 = eng.volumes.device_pools()[0]
    pool = pool0.view(pool0.shape[0], pool0.shape[1], -1)
    got = read_parity(torch, pool, reads)
    emit(phase="kernel_parity", kernel="dbs_rw_read",
         width="zero-copy serving", pool_shape=list(pool.shape),
         batches=len(reads), lanes=got["lanes"], hole_lanes=got["hole_lanes"],
         max_abs_err=got["max_abs_err"], ms=got["ms"],
         bound_ms=got["bound_ms"], library_ms=got["library_ms"],
         resources=got["resources"], equal=True)
    return got


def phase_write_kernel_serve(torch, eng, writes):
    """Parity and timing of dbs_rw_write at a zero-copy serving width, on
    replica 0's (src, dst, lane_of, payload) calls kept from every
    READ_SERVE_EVERY-th write pump of the serve path's traffic, replayed
    on a copy of its replica-0 pool (whose rows they route over) through
    the kernel and, on a second copy, through the plain version: equal bit
    for bit; timed as in phase 3."""
    if not writes:
        raise AssertionError("no write-kernel inputs were kept on the serve "
                             "path")
    pool0 = eng.volumes.device_pools()[0]
    pool = pool0.view(pool0.shape[0], pool0.shape[1], -1).clone()
    got = write_parity(torch, pool, writes)
    emit(phase="kernel_parity", kernel="dbs_rw_write",
         width="zero-copy serving", pool_shape=list(pool.shape),
         calls=got["calls"], lanes=got["lanes"],
         rows_written=got["rows_written"], max_abs_err=got["max_abs_err"],
         ms=got["ms"], bound_ms=got["bound_ms"],
         library_ms=got["library_ms"], resources=got["resources"],
         equal=True)
    del pool
    torch.cuda.empty_cache()
    return got


# ---------------------------------------------------------------------------
# the launch floor: the least a launched graph node costs
# ---------------------------------------------------------------------------
def phase_launch_floor(torch, dev, smi, n=64):
    """``graph_ms`` of a one-element ``zero_()`` per call: a kernel that
    moves 4 bytes, so its time is what any launched node costs in the
    same graph harness. A kernel timed here cannot go below it."""
    from repro_torch.kernels.timing import graph_ms
    x = torch.ones(1, device=dev)
    ms = graph_ms(lambda: [x.zero_() for _ in range(n)], n)
    emit(phase="launch_floor", op="zero_() of one fp32 element",
         calls_per_pass=n, ms=ms, card=smi)
    return ms


# ---------------------------------------------------------------------------
# phases 5 and 8: the block device's trace, on any backend and kernel
# ---------------------------------------------------------------------------
class Shadow:
    """Host shadow of every written 4 KiB block (holes read as zeros)."""

    def __init__(self):
        self.blocks = {}            # (vid, abs block) -> bytes

    def write(self, vid, off, data):
        first, last = off // BLOCK, (off + len(data) - 1) // BLOCK
        for ab in range(first, last + 1):
            cur = bytearray(self.blocks.get((vid, ab), bytes(BLOCK)))
            lo, hi = max(off, ab * BLOCK), min(off + len(data), (ab + 1) * BLOCK)
            cur[lo - ab * BLOCK:hi - ab * BLOCK] = data[lo - off:hi - off]
            self.blocks[(vid, ab)] = bytes(cur)

    def read(self, vid, off, n):
        first, last = off // BLOCK, (off + n - 1) // BLOCK
        buf = b"".join(self.blocks.get((vid, ab), bytes(BLOCK))
                       for ab in range(first, last + 1))
        return buf[off - first * BLOCK:off - first * BLOCK + n]

    def clone(self, src, dst):
        for (vid, ab), v in list(self.blocks.items()):
            if vid == src:
                self.blocks[(dst, ab)] = v

    def drop(self, vid):
        for key in [k for k in self.blocks if k[0] == vid]:
            del self.blocks[key]


def count_syncs(torch, fn) -> int:
    """Run ``fn()`` under ``torch.cuda.set_sync_debug_mode("warn")`` and
    count the synchronising CUDA calls it made (device-to-host copies,
    ``.tolist()``/``.item()``, pageable host-to-device copies, stream
    synchronisations), one warning each. The notice that the first
    switch to a debug mode prints once a process ("Synchronization debug
    mode is a prototype feature ...") is not a sync and is not counted."""
    import warnings
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return sum("synchroniz" in str(w.message)
               and "prototype" not in str(w.message) for w in seen)


def phase_main(torch, args, dev, smi, backend="fused", kernel="cuda",
               n_ops=N_OPS, max_ops=None, column=None, fail_after=None,
               n_volumes=1, fail_shard=None, sample_every=READ_SAMPLE_EVERY,
               rebuild_after=None, **extra):
    """The block device's trace through ``VolumeManager(backend, kernel,
    **extra)`` at the main path's geometry (``extra``: storage, replicas,
    transport and policies, shards and extents). ``n_ops`` scales the trace
    (the random phases, the sequential spans and the hole reads);
    ``max_ops`` stops it early (after a settle of the reads so far);
    ``fail_after`` flushes and fails replica 1 (of shard ``fail_shard`` on
    the sharded pool and the ring) once that many ops were issued, and
    ``rebuild_after`` flushes and rebuilds it once that many were, timed
    between two synchronisations (on the ring both are in-band requests). ``n_volumes`` base
    volumes share the trace (the random ops pick one uniformly, the
    sequential spans too; each is snapshotted and cloned); with one, the
    trace is the main path's. Every read is checked, the healthy DBS
    replicas must agree, and the kernels of the path must have launched.
    ``column`` labels the printed line. The read kernel's inputs of every
    ``sample_every``-th step are kept; on the sharded pool and the ring
    the write kernel's too (replica 0's call), and pumps count the pool's
    dispatches."""
    import numpy as np
    from repro_torch.core import slots
    from repro_torch.core.blockdev import VolumeManager
    from repro_torch.kernels.dbs import copy_kernel, rw_kernel
    from repro_torch.core import backends
    from repro_torch.kernels.dbs import ops
    rng = np.random.default_rng(SEED + 1)
    torch.cuda.reset_peak_memory_stats()
    config = dict(backend=backend, kernel=kernel, n_replicas=REPLICAS,
                  payload_elems=BLOCK, page_blocks=PAGE_BLOCKS,
                  max_pages=args.max_pages, n_extents=args.n_extents,
                  max_volumes=16, batch=BATCH, n_slots=256, n_queues=4)
    config.update(extra)
    mgr = VolumeManager(device=dev, **config)
    # count pumps that did work, the fused steps by kind and the copy
    # kernel's live lanes (summed on the device); keep the read kernel's
    # inputs of every READ_SAMPLE_EVERY-th step for phase 6 and the copy
    # kernel's of every COPY_SAMPLE_EVERY-th call for phase 8
    steps = {"write": 0, "read_only": 0}
    pumps = [0]
    reads, copies, writes = [], [], []
    copy_calls = [0]
    copied = [torch.zeros((), dtype=torch.int64, device=dev)]
    impl = mgr.engine.impl
    sharded = backend in ("sharded", "ring")   # a ShardedReplicaGroup
    ring = backend == "ring"
    inner = {"fused_step": backends.fused_step,
             "fused_step_read": backends.fused_step_read,
             "dbs_rw_read": ops.dbs_rw_read, "dbs_copy": ops.dbs_copy,
             "dbs_rw_write": ops.dbs_rw_write, "pump": impl.pump}

    def pump():
        got = inner["pump"]()
        pumps[0] += got > 0
        return got

    def n_pumps():
        return impl.dispatches if sharded else pumps[0]

    def n_steps_now():
        return (sum(impl.step_counts.values()) if sharded
                else sum(steps.values()))

    def write_step(*a, **k):
        steps["write"] += 1
        return inner["fused_step"](*a, **k)

    def read_step(*a, **k):
        steps["read_only"] += 1
        return inner["fused_step_read"](*a, **k)

    def read_kernel(pool, ext, block):
        if (n_steps_now() % sample_every == 1
                and len(reads) < READ_SAMPLES):
            reads.append((ext.clone(), block.clone()))
        return inner["dbs_rw_read"](pool, ext, block)

    kept_step = [None]

    def write_kernel(pool, src, dst, lane_of, payload, **k):
        step = n_steps_now()
        if (sharded and step % sample_every == 1
                and kept_step[0] != step and len(writes) < READ_SAMPLES):
            kept_step[0] = step                  # replica 0's call
            writes.append(tuple(t.clone() for t in (src, dst, lane_of,
                                                    payload)))
        return inner["dbs_rw_write"](pool, src, dst, lane_of, payload, **k)

    def copy(pool, src, dst, mask, **k):
        copied[0] += mask.sum()
        if copy_calls[0] % COPY_SAMPLE_EVERY == 0:
            copies.append((src.clone(), dst.clone(), mask.clone()))
        copy_calls[0] += 1
        return inner["dbs_copy"](pool, src, dst, mask, **k)
    impl.pump = pump
    backends.fused_step, backends.fused_step_read = write_step, read_step
    ops.dbs_rw_read, ops.dbs_copy = read_kernel, copy
    ops.dbs_rw_write = write_kernel
    shadow = Shadow()
    cap = mgr.capacity
    n_blocks = cap // BLOCK
    stats = {"ops": 0, "bytes": 0, "reads_checked": 0, "rmw_writes": 0}
    checks = []                       # (future, expected bytes)
    harness = [0.0]                   # seconds spent making and checking data
    failed = [None]                   # the op count replica 1 failed at
    rebuilt = [None, None]            # the op count and seconds of its rebuild

    def count_op():
        stats["ops"] += 1
        where = {} if fail_shard is None else {"shard": fail_shard}
        if (fail_after is not None and failed[0] is None
                and stats["ops"] >= fail_after):
            mgr.flush()
            mgr.engine.control("fail", replica=1, **where)
            failed[0] = stats["ops"]
        if (rebuild_after is not None and rebuilt[0] is None
                and stats["ops"] >= rebuild_after):
            mgr.flush()
            torch.cuda.synchronize()
            t = time.perf_counter()
            mgr.engine.control("rebuild", replica=1, **where)
            torch.cuda.synchronize()
            rebuilt[:] = [stats["ops"], time.perf_counter() - t]

    def off_clock(fn, *a):
        """Run ``fn(*a)`` and book its time as the harness's own."""
        t = time.perf_counter()
        out = fn(*a)
        harness[0] += time.perf_counter() - t
        return out

    def rand_bytes(n):
        return off_clock(
            lambda: rng.integers(0, 256, n, dtype=np.uint8).tobytes())

    def write(vol, off, data):
        vol.pwrite(off, data)
        off_clock(shadow.write, vol.vid, off, data)
        count_op()
        stats["bytes"] += len(data)
        if off % BLOCK or len(data) % BLOCK:
            stats["rmw_writes"] += 1

    def read(vol, off, n):
        fut = vol.pread(off, n)
        checks.append((fut, off_clock(shadow.read, vol.vid, off, n)))
        count_op()
        stats["bytes"] += n

    def settle():
        for fut, want in checks:
            if off_clock(lambda got: got != want, fut.result()):
                raise AssertionError("a read returned the wrong bytes")
        stats["reads_checked"] += len(checks)
        checks.clear()

    class Enough(Exception):
        """``max_ops`` reached: the trace stops here."""

    def random_io(vols, n_ops, hot=None):
        for _ in range(n_ops):
            if max_ops is not None and stats["ops"] >= max_ops:
                raise Enough
            vol = vols[rng.integers(len(vols))]
            r = rng.random()
            if hot and rng.random() < 0.7:
                ab = hot[rng.integers(len(hot))]
            else:
                ab = int(rng.integers(n_blocks))
            if r < 0.10:                             # unaligned: RMW path
                off = ab * BLOCK + int(rng.integers(1, BLOCK))
                n = int(rng.integers(1, 2 * BLOCK))
                write(vol, off, rand_bytes(min(n, cap - off)))
            elif r < 0.55:
                write(vol, ab * BLOCK, rand_bytes(BLOCK))
                if hot is not None and len(hot) < 4096:
                    hot.append(ab)
            else:
                read(vol, ab * BLOCK, BLOCK)

    n = n_ops
    for mod in (rw_kernel, copy_kernel):
        mod.reset_counts()
    t0 = time.perf_counter()
    v0 = mgr.create()
    base = [v0] + [mgr.create() for _ in range(n_volumes - 1)]
    clones = []
    hot = []
    try:
        random_io(base, n // 2, hot)                 # 4 KiB random I/O
        page_bytes = mgr.page_bytes
        for _ in range(max(1, 128 * n // N_OPS)):    # 128 KiB sequential
            vol = base[rng.integers(n_volumes)] if n_volumes > 1 else v0
            p = int(rng.integers(args.max_pages - 4))
            for k in range(4):
                write(vol, (p + k) * page_bytes, rand_bytes(page_bytes))
            read(vol, p * page_bytes, 4 * page_bytes)
        settle()
        for vol in base:
            vol.snapshot()
        random_io(base, n // 6, hot)                 # CoW overwrites
        for vol in base:
            clones.append(vol.clone())
            off_clock(shadow.clone, vol.vid, clones[-1].vid)
        random_io(base + clones, n // 6, hot)        # the clones diverge
        settle()
        for vol in base + clones:                    # discard: TRIM + edges
            for _ in range(4):
                p = int(rng.integers(args.max_pages - 4))
                off = p * page_bytes + int(rng.integers(1, page_bytes))
                nb = 2 * page_bytes + int(rng.integers(1, page_bytes))
                vol.discard(off, nb)
                off_clock(shadow.write, vol.vid, off, bytes(nb))
                count_op()
                read(vol, off - 100, nb + 200)
        settle()
        for vol in base + clones:                    # every written block
            for ab in off_clock(lambda: [ab for (vid, ab) in shadow.blocks
                                         if vid == vol.vid]):
                read(vol, ab * BLOCK, BLOCK)
        for _ in range(max(8, 256 * n // N_OPS)):    # and some holes
            read(v0, int(rng.integers(n_blocks)) * BLOCK, BLOCK)
        settle()
        for c in clones:
            c.delete()
            off_clock(shadow.drop, c.vid)
        random_io(base, n // 6, hot)
    except Enough:
        pass
    settle()
    mgr.flush()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {**rw_kernel.LAUNCHES, **copy_kernel.LAUNCHES}
    plain = {**rw_kernel.PLAIN_CALLS, **copy_kernel.PLAIN_CALLS}
    lanes_copied = int(copied[0])
    work_pumps = n_pumps()
    n_steps = n_steps_now()
    # the trace's steps by kind (the sync window's come after)
    if ring:
        trace_steps = {"write": impl.write_steps,
                       "read_only": impl.dispatches - impl.write_steps}
    elif sharded:
        trace_steps = {"write": impl.step_counts["step"],
                       "read_only": impl.step_counts["step_read"]}
    else:
        trace_steps = dict(steps)

    # host synchronisations per pump, in a window after the trace: 64
    # aligned 4 KiB writes and 64 reads of them
    def window():
        for i in range(BATCH):
            v0.pwrite((i * 97 % n_blocks) * BLOCK, bytes([i]) * BLOCK)
            shadow.write(v0.vid, (i * 97 % n_blocks) * BLOCK,
                         bytes([i]) * BLOCK)
        futs = [v0.pread((i * 97 % n_blocks) * BLOCK, BLOCK)
                for i in range(BATCH)]
        mgr.flush()
        if [f.result() for f in futs] != [bytes([i]) * BLOCK
                                          for i in range(BATCH)]:
            raise AssertionError("the sync window read wrong bytes")
    pumps[0] = 0
    pumps0 = n_pumps()
    syncs = count_syncs(torch, window)
    window_pumps = n_pumps() - pumps0
    # the sharded pool's completion waits on a CUDA event, which sync-debug
    # does not report: one wait a pump, counted here
    event_waits = window_pumps if sharded else 0
    impl.pump = inner["pump"]
    backends.fused_step = inner["fused_step"]
    backends.fused_step_read = inner["fused_step_read"]
    ops.dbs_rw_read, ops.dbs_copy = inner["dbs_rw_read"], inner["dbs_copy"]
    ops.dbs_rw_write = inner["dbs_rw_write"]
    need = {("fused", "cuda"): ("dbs_rw_write", "dbs_rw_read"),
            ("sharded", "cuda"): ("dbs_rw_write", "dbs_rw_read"),
            ("ring", "cuda"): ("dbs_rw_write", "dbs_rw_read"),
            ("fused", "copy"): ("dbs_copy",),
            ("ring", "copy"): ("dbs_copy",)}.get((backend, kernel), ())
    if any(launches[k] <= 0 for k in need):
        raise AssertionError(f"a kernel of the path never launched: "
                             f"{launches}")
    # one read launch a step; on the sharded pool and the ring one routed
    # launch a replica, and one write launch a replica a write step, at
    # any S
    per_step = REPLICAS if sharded else 1
    if kernel == "cuda" and launches["dbs_rw_read"] != n_steps * per_step:
        raise AssertionError(f"{launches['dbs_rw_read']} read launches "
                             f"over {n_steps} steps")
    if sharded and kernel == "cuda" and (launches["dbs_rw_write"]
                                         != REPLICAS * trace_steps["write"]):
        raise AssertionError(f"{launches['dbs_rw_write']} write launches "
                             f"over {trace_steps['write']} write steps")
    if kernel == "copy" and lanes_copied <= 0:
        raise AssertionError("the copy path copied no CoW lane")
    group = mgr.engine.backend
    rows = torch.zeros((0,), dtype=torch.int64, device=dev)
    if hasattr(group, "replicas"):            # DBS replicas: they agree
        if not group.consistent():
            raise AssertionError("replicas disagree on the metadata "
                                 "revision")
        healthy = [group.replicas[i] for i in group.healthy_indices()]
        st0 = healthy[0].state
        rows = torch.unique(st0.table[st0.table >= 0]).long()
        for r in healthy[1:]:
            if not torch.equal(r.state.table, st0.table):
                raise AssertionError("replica extent maps differ")
            for i in range(0, rows.numel(), 1024):
                part = rows[i:i + 1024]
                if not torch.equal(r.pool[part], healthy[0].pool[part]):
                    raise AssertionError("replica pools differ on mapped "
                                         "rows")
    n_mapped = int(rows.numel())
    if sharded:                               # per shard, the same
        if not group.consistent():
            raise AssertionError("a shard's replicas disagree on the "
                                 "metadata revision")
        for sh in range(group.n_shards):
            live = [r for r in range(REPLICAS) if group.healthy[sh, r]]
            t0 = group.states[live[0]].table[sh]
            rows = torch.unique(t0[t0 >= 0]).long()
            n_mapped += rows.numel()
            for r in live[1:]:
                if not torch.equal(group.states[r].table[sh], t0):
                    raise AssertionError(f"shard {sh}: extent maps differ")
                for i in range(0, rows.numel(), 1024):
                    part = rows[i:i + 1024]
                    if not torch.equal(group.pools[r][sh][part],
                                       group.pools[live[0]][sh][part]):
                        raise AssertionError(f"shard {sh}: replica pools "
                                             "differ on mapped rows")
    if any(plain.values()):
        raise AssertionError(f"plain versions ran on the card: {plain}")
    table = getattr(mgr.engine.frontend, "table", None)
    if table is not None and int(slots.n_active(table)) != 0:
        raise AssertionError("slots leaked")
    out = dict(
        config=config, volume_bytes=cap, ops=stats["ops"],
        rmw_writes=stats["rmw_writes"],
        reads_checked=stats["reads_checked"], bytes=stats["bytes"],
        seconds=seconds, harness_seconds=harness[0],
        ops_per_s=stats["ops"] / seconds,
        mib_per_s=stats["bytes"] / seconds / 2 ** 20,
        engine_ops_per_s=stats["ops"] / (seconds - harness[0]),
        pumps=work_pumps, ops_per_pump=stats["ops"] / work_pumps,
        host_syncs_per_pump=(syncs + event_waits) / window_pumps,
        sync_window=dict(ops=2 * BATCH, pumps=window_pumps, syncs=syncs,
                         event_waits=event_waits),
        launches=launches, plain_calls=plain,
        mapped_rows=n_mapped,
        max_memory_allocated=torch.cuda.max_memory_allocated(dev), card=smi)
    if backend in ("fused", "sharded", "ring"):
        out.update(write_steps=trace_steps["write"],
                   read_only_steps=trace_steps["read_only"],
                   ops_per_step=stats["ops"] / n_steps)
    if ring:
        out.update(steps_by_signature={"+".join(k): v for k, v in
                                       impl.step_counts.items()})
    if sharded:
        out.update(n_shards=impl.n_shards, volumes=n_volumes,
                   launches_per_pump={k: launches[k] / n_steps
                                      for k in ("dbs_rw_write",
                                                "dbs_rw_read")},
                   write_launches_per_write_pump=(launches["dbs_rw_write"]
                                                  / trace_steps["write"]))
    if kernel == "copy":
        out.update(cow_lanes_copied=lanes_copied)
    if column is not None:
        out.update(column=column)
    if rebuild_after is not None:
        out.update(replica_1_rebuilt_at_op=rebuilt[0],
                   rebuild_seconds=rebuilt[1])
    if fail_after is not None:
        out.update(replica_1_failed_at_op=failed[0])
        if fail_shard is not None:
            out.update(failed_shard=fail_shard)
    emit(phase="main_path" if n_ops == N_OPS and column is None
         else "block_device", **out)
    return mgr, launches, max(n_steps, 1), {
        "dbs_rw_read": reads, "dbs_copy": copies, "dbs_rw_write": writes,
        "shadow": shadow, "volumes": base}, out


# ---------------------------------------------------------------------------
# phases 8a-8e: the controller slice on the block device
# ---------------------------------------------------------------------------
def ladder_engine(torch, column, row, dev, args, **kw):
    """The ladder's column map (a copy of benchmarks/ladder.py
    ``make_engine``, which imports JAX), the ported columns only, at the
    main path's geometry: ``row`` picks the null layer cut."""
    from repro_torch.core.engine import Engine, EngineConfig, UpstreamEngine
    base = dict(payload_shape=(BLOCK,), n_replicas=REPLICAS,
                page_blocks=PAGE_BLOCKS, n_extents=args.n_extents,
                max_pages=args.max_pages, batch=BATCH,
                null_backend=row == "frontend_only",
                null_storage=row == "without_storage", kernel="cuda",
                device=dev)
    base.update(kw)
    if column == "upstream":
        return UpstreamEngine(EngineConfig(**base))
    comm, storage = {"+frontend": ("loop", "chained"),
                     "+comm": ("slots", "chained"),
                     "+dbs": ("slots", "dbs"),
                     "+fused": ("fused", "dbs"),
                     "+sharded": ("sharded", "dbs"),
                     "+ring": ("ring", "dbs")}[column]
    if column in ("+sharded", "+ring"):  # the main path's extents in all
        base.setdefault("n_shards", SHARDS)
        if "n_extents" not in kw:
            base["n_extents"] = args.n_extents // base["n_shards"]
    return Engine(EngineConfig(comm=comm, storage=storage, **base))


def timed_rounds(torch, submit, drain, check=None):
    """Repeat rounds of ``submit()`` (untimed) and ``drain()`` (timed, with
    a synchronise before and after) until the timed part adds up to
    ``MIN_WINDOW_S``; ``check`` runs after each round, untimed. Returns
    (items completed, seconds timed, rounds)."""
    done, seconds, rounds = 0, 0.0, 0
    while seconds < MIN_WINDOW_S:
        submit()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        done += drain()
        torch.cuda.synchronize()
        seconds += time.perf_counter() - t0
        rounds += 1
        if check is not None:
            check()
    return done, seconds, rounds


def measure_engine(torch, eng, n_requests, n_volumes=4, seed=SEED):
    """ops/s of timed drains of a seeded mix of 4 KiB block requests (odd
    requests write, even ones read) spread round-robin over ``n_volumes``
    volumes, after a warm-up drain of one write batch, one read batch and
    one mixed batch (benchmarks/ladder.py ``measure_engine``'s protocol,
    through the ``Engine`` request API). The same ``n_requests`` are
    submitted again until the drains add up to ``MIN_WINDOW_S``. Returns
    (ops/s, seconds timed, rounds)."""
    import numpy as np
    from repro_torch.core.frontend import Request
    vols = [eng.create_volume() for _ in range(n_volumes)]
    pages = eng.cfg.max_pages
    page_seq = np.random.default_rng(seed).integers(0, pages,
                                                    size=n_requests)
    payload = np.ones(BLOCK, np.float32)
    for i in range(3 * BATCH):                  # warm-up: w, r, mixed
        kind = ("write", "read", ("read", "write")[i % 2])[i // BATCH]
        eng.submit(Request(req_id=i, kind=kind, volume=vols[i % n_volumes],
                           page=i % pages, block=i % 8, payload=payload))
        if i % BATCH == BATCH - 1:
            eng.drain()
    eng.completed = 0

    def submit():
        for i in range(n_requests):
            eng.submit(Request(req_id=i, kind="write" if i % 2 else "read",
                               volume=vols[i % n_volumes],
                               page=int(page_seq[i]), block=i % 8,
                               payload=payload))
    done, seconds, rounds = timed_rounds(torch, submit, eng.drain)
    if done != n_requests * rounds:
        raise AssertionError(f"{done} of {n_requests * rounds} requests "
                             "completed")
    return done / seconds, seconds, rounds


def phase_layer_rows(torch, args, dev, smi):
    """Every ported ladder column under the paper's three rows (§IV-A):
    ``frontend_only`` (null_backend), ``without_storage`` (null_storage),
    ``full_engine``; ops/s per cell, each over at least ``MIN_WINDOW_S``
    of drains."""
    out, windows = {}, {}
    for column in LAYER_COLUMNS:
        n = LAYER_OPS[column in PER_REQUEST_COLUMNS]
        out[column], windows[column] = {}, {}
        for row in LAYER_ROWS:
            eng = ladder_engine(torch, column, row, dev, args)
            ops, seconds, rounds = measure_engine(torch, eng, n)
            out[column][row] = ops
            windows[column][row] = dict(seconds=seconds, rounds=rounds)
            del eng
            gc.collect()
            torch.cuda.empty_cache()
    emit(phase="layer_rows", requests={c: LAYER_OPS[c in PER_REQUEST_COLUMNS]
                                       for c in LAYER_COLUMNS},
         volumes=4, ops_per_s=out, windows=windows, card=smi)
    return out


def volume_digest(torch, pool, table_row, chunk=256):
    """A float64 checksum of one volume's logical contents (holes as
    zeros), each element weighted by a fixed irrational fraction of its
    position: equal contents give equal sums, computed on the device."""
    tot = torch.zeros((), dtype=torch.float64, device=pool.device)
    per_page = pool[0].numel()
    for lo in range(0, table_row.numel(), chunk):
        ext = table_row[lo:lo + chunk].long()
        rows = pool[ext.clamp(min=0)].double()
        rows *= (ext >= 0).view(-1, *[1] * (rows.dim() - 1))
        idx = torch.arange(lo * per_page, (lo + ext.numel()) * per_page,
                           dtype=torch.float64, device=pool.device)
        w = torch.frac(idx * 0.6180339887498949) + 0.5
        tot += (rows.reshape(-1) * w).sum()
    return float(tot)


@contextlib.contextmanager
def host_ms_by_op(replicas, out):
    """Add to ``out[opcode name]`` the host milliseconds that each replica
    endpoint spends executing a message: kernel enqueues, allocator calls,
    lazy kernel loads and any copy that waits on the device. A clock read
    a message and no synchronisation are added."""
    from repro_torch.core.transport import MSG_NAMES

    def wrap(execute):
        def run(msg):
            t = time.perf_counter()
            try:
                return execute(msg)
            finally:
                k = MSG_NAMES[msg.op]
                out[k] = out.get(k, 0.0) + (time.perf_counter() - t) * 1e3
        return run
    for r in replicas:
        r.execute = wrap(r.execute)
    try:
        yield out
    finally:
        for r in replicas:
            del r.execute


def phase_rebuild(torch, args, dev, smi, trace_ops):
    """The full trace on a fused/cuda manager with replica 1 failed after
    half its ops, then ``control("rebuild", replica=1)`` timed alone (a
    synchronise before and after, no sync-debug mode), with its messages,
    moved rows and host time per opcode; the rebuilt replica then serves
    every written block alone, and rebuilding replicas 0 and 2 after that
    moves nothing. Three repeats follow, each on a new delta of the same
    row count (replica 1 failed again, one block of each of the first
    ``moved`` mapped pages rewritten with the bytes it holds): timed
    again, timed after ``torch.cuda.empty_cache()`` (the allocator grows
    again, the kernels stay loaded), and run under sync-debug "warn" to
    count its host syncs."""
    mgr, launches, n_steps, kept, out = phase_main(
        torch, args, dev, smi, column="rebuild", fail_after=trace_ops // 2)
    g = mgr.engine.backend
    row_bytes = PAGE_BLOCKS * BLOCK * 4
    st = g.replicas[0].state
    rows = torch.unique(st.table[st.table >= 0]).long()

    def timed_rebuild():
        moved0 = g.transports[1].pages_moved
        sent0 = [dict(t.sent) for t in g.transports]
        by_op = {}
        torch.cuda.synchronize()
        with host_ms_by_op(g.replicas, by_op):
            t = time.perf_counter()
            mgr.engine.control("rebuild", replica=1)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t
        msgs = {}
        for tr, before in zip(g.transports, sent0):
            for k, v in tr.sent.items():
                if v - before.get(k, 0):
                    msgs[k] = msgs.get(k, 0) + v - before.get(k, 0)
        moved = g.transports[1].pages_moved - moved0
        return dict(seconds=dt, extents_moved=moved,
                    bytes_moved=moved * row_bytes,
                    bound_ms=2 * moved * row_bytes / HBM_BYTES_PER_S * 1e3,
                    host_ms_by_op=by_op, messages=msgs)

    def check_rebuilt(what):
        if not g.consistent():
            raise AssertionError(f"replicas disagree after {what}")
        for i in range(0, rows.numel(), 1024):
            part = rows[i:i + 1024]
            if not torch.equal(g.replicas[1].pool[part],
                               g.replicas[0].pool[part]):
                raise AssertionError(f"{what}: the rebuilt pool differs "
                                     "from the donor")
    cold = timed_rebuild()
    moved = cold["extents_moved"]
    check_rebuilt("the rebuild")
    # the rebuilt replica alone serves every written block
    mgr.engine.control("fail", replica=0)
    mgr.engine.control("fail", replica=2)
    shadow, (v0,) = kept["shadow"], kept["volumes"]
    written = sorted(ab for (vid, ab) in shadow.blocks if vid == v0.vid)
    futs = [(v0.pread(ab * BLOCK, BLOCK), ab) for ab in written]
    mgr.flush()
    for fut, ab in futs:
        if fut.result() != shadow.read(v0.vid, ab * BLOCK, BLOCK):
            raise AssertionError("the rebuilt replica read wrong bytes")
    del futs
    for i in (0, 2):                             # nothing written: no rows
        before = sum(t.pages_moved for t in g.transports)
        mgr.engine.control("rebuild", replica=i)
        if sum(t.pages_moved for t in g.transports) != before:
            raise AssertionError(f"rebuilding replica {i} moved rows")
    if not g.consistent() or len(g.healthy_indices()) != REPLICAS:
        raise AssertionError("the three replicas disagree")
    if moved <= 0 or launches["dbs_rw_write"] <= 0 \
            or launches["dbs_rw_read"] <= 0:
        raise AssertionError(f"moved {moved} rows; launches {launches}")
    table = g.replicas[0].state.table[v0.vid]
    pages = torch.nonzero(table >= 0).flatten().tolist()[:moved]

    def new_delta():
        mgr.engine.control("fail", replica=1)
        for p in pages:
            off = p * PAGE_BLOCKS * BLOCK
            v0.pwrite(off, shadow.read(v0.vid, off, BLOCK))
        mgr.flush()
    new_delta()
    warm = timed_rebuild()
    check_rebuilt("the warm rebuild")
    new_delta()
    torch.cuda.empty_cache()
    regrown = timed_rebuild()
    check_rebuilt("the rebuild after empty_cache")
    new_delta()
    syncs = count_syncs(torch, lambda: mgr.engine.control("rebuild",
                                                          replica=1))
    check_rebuilt("the counted rebuild")
    del kept
    res = dict(
        ops=out["ops"], replica_1_failed_at_op=out["replica_1_failed_at_op"],
        trace_ops_per_s=out["ops_per_s"], **cold,
        warm=warm, after_empty_cache=regrown, host_syncs=syncs,
        bound_by="bytes: each moved row read once from the donor and "
                 "written once to the target, at 3.35 TB/s",
        blocks_checked_on_replica_1_alone=len(written),
        mapped_rows=int(rows.numel()), launches=launches, card=smi)
    emit(phase="rebuild", **res)
    mgr.close()
    return res


def phase_replication(torch, args, dev, smi):
    """The reference's policy matrix (benchmarks/ladder.py
    ``run_replication``) on ``slots`` (+dbs) over the ladder's cut trace,
    every read checked: ops/s, the controller's wait in simulated ticks,
    retransmits and messages sent; after ``close()`` every case's replicas
    agree and every case ends in the same bytes."""
    out, digests = {}, {}
    for name, kw in REPLICATION:
        mgr, _l, _s, kept, res = phase_main(
            torch, args, dev, smi, backend="slots", kernel="torch",
            n_ops=LADDER_OPS, column=f"replication {name}", **kw)
        mgr.close()
        g = mgr.engine.backend
        if not g.consistent():
            raise AssertionError(f"{name}: replicas disagree after close")
        vid = kept["volumes"][0].vid
        del kept
        digests[name] = [volume_digest(torch, r.pool, r.state.table[vid])
                         for r in g.replicas]
        out[name] = dict(
            ops_per_s=res["ops_per_s"], mib_per_s=res["mib_per_s"],
            pumps=res["pumps"], wait_ticks=g.wait_ticks,
            wait_ticks_per_op=g.wait_ticks / res["ops"],
            retransmits=sum(t.retransmits for t in g.transports),
            messages_sent=sum(t.messages_sent() for t in g.transports),
            reads_checked=res["reads_checked"])
        del mgr, g
        gc.collect()
        torch.cuda.empty_cache()
    flat = {d for ds in digests.values() for d in ds}
    if len(flat) != 1:
        raise AssertionError(f"the cases end in different bytes: {digests}")
    emit(phase="replication", cases=out, digest=flat.pop(), card=smi)
    return out


def phase_snapshot_depth(torch, args, dev, smi):
    """Reads against a volume whose data lies under 0, 4, 16 and 64
    snapshots (benchmarks/ladder.py ``snapshot_degradation``: one block of
    every page written before the first snapshot, then a snapshot and a
    write of page 0 per newer layer; reads of random pages other than 0)
    at the main path's geometry, with ``SNAP_VOLUMES`` volume slots for
    the snapshot table. One engine a backend takes the snapshots in
    steps, which leaves the same layers as a fresh engine a depth. Reads/s
    over at least ``MIN_WINDOW_S`` of drains, every read checked, and
    layers walked per read on ``upstream`` (the chain walk grows with the
    snapshots) and on ``fused`` (one table gather)."""
    import numpy as np
    from repro_torch.core.engine import Engine, EngineConfig
    from repro_torch.core.frontend import Request
    pages = args.max_pages
    payload = np.ones(BLOCK, np.float32)
    rng = np.random.default_rng(SEED)
    res = {}
    for backend in ("upstream", "fused"):
        res[backend] = []
        eng = Engine(EngineConfig(
            comm=backend, payload_shape=(BLOCK,), n_replicas=REPLICAS,
            page_blocks=PAGE_BLOCKS, max_pages=pages,
            max_volumes=SNAP_VOLUMES, n_extents=args.n_extents, batch=BATCH,
            kernel="cuda", device=dev))
        vol = eng.create_volume()
        for p in range(pages):                    # data in the oldest layer
            eng.submit(Request(req_id=p, kind="write", volume=vol,
                               page=p, block=0, payload=payload))
        eng.drain()
        depth = 0
        for ns in SNAP_DEPTHS:
            for _ in range(ns - depth):           # newer layers
                sid = eng.snapshot(vol)
                if backend == "fused" and sid < 0:
                    raise AssertionError("the snapshot table is full")
                eng.submit(Request(req_id=0, kind="write", volume=vol,
                                   page=0, block=0, payload=payload))
                eng.drain()
            depth = ns
            stores = getattr(eng.impl, "stores", None) or []
            before = [(s.reads, s.layers_walked) for s in stores]
            rs = []

            def submit():
                rs[:] = [Request(req_id=i, kind="read", volume=vol,
                                 page=int(rng.integers(1, pages)), block=0)
                         for i in range(SNAP_READS)]
                for r in rs:
                    eng.submit(r)

            def check():
                if any(r.result is None
                       or not np.array_equal(r.result, payload)
                       for r in rs):
                    raise AssertionError(f"{backend}, {ns} snapshots: a "
                                         "read returned the wrong block")
            done, seconds, rounds = timed_rounds(torch, submit, eng.drain,
                                                 check)
            if done != SNAP_READS * rounds:
                raise AssertionError(f"{done} of {SNAP_READS * rounds} "
                                     "reads completed")
            if stores:
                reads = sum(s.reads - b[0] for s, b in zip(stores, before))
                walked = sum(s.layers_walked - b[1]
                             for s, b in zip(stores, before))
                per_read = walked / reads
                if per_read != ns + 1:
                    raise AssertionError(f"{per_read} layers a read under "
                                         f"{ns} snapshots")
            else:
                per_read = 1.0                    # one table gather
            res[backend].append(dict(snapshots=ns, reads_per_s=done / seconds,
                                     layers_per_read=per_read, reads=done,
                                     seconds=seconds, rounds=rounds))
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    emit(phase="snapshot_depth", pages=pages, n_extents=args.n_extents,
         max_volumes=SNAP_VOLUMES, reads_a_round=SNAP_READS, points=res,
         card=smi)
    return res


# ---------------------------------------------------------------------------
# phase 7: the fused step never waits on the host
# ---------------------------------------------------------------------------
# ---------------------------------------------------------------------------
# phases 8f-8j: the shards slice (EnginePool, backend="sharded")
# ---------------------------------------------------------------------------
def sharded_config(args, n_shards=SHARDS):
    """``phase_main``'s arguments for the sharded byte API: S shards of
    the main path's extents shared out (the same total, so the same 19.3 GB
    of pools), one base volume a shard, the ladder's cut trace."""
    return dict(backend="sharded", n_shards=n_shards,
                n_extents=args.n_extents // n_shards, n_ops=LADDER_OPS,
                n_volumes=n_shards, sample_every=SHARDED_SAMPLE_EVERY)


def phase_no_sync_sharded(torch, mgr):
    """One pump of the sharded pool under sync-debug "error", from
    ``pump_async`` (the drain, the staging through pinned memory, the
    vmapped metadata step, the kernels, the completion copies) to the
    recorded event: 64 writes and 64 reads over every shard's volume."""
    pool = mgr.engine.pool
    vols = [mgr.open(v) for v in range(pool.n_shards)]
    futs = [vols[i % len(vols)].pwrite(i * 11 * BLOCK, bytes([i]) * BLOCK)
            for i in range(BATCH)]
    futs += [vols[i % len(vols)].pread(i * 11 * BLOCK, BLOCK)
             for i in range(BATCH)]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        pending = pool.pump_async()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    if pending is None:
        raise AssertionError("the guarded sharded pump found no request")
    done = pool._complete(pending)
    mgr.flush()
    if not all(f.done() for f in futs):
        raise AssertionError("the guarded sharded pump's I/O did not "
                             "complete")
    emit(phase="no_sync", path="sharded", shards=pool.n_shards,
         guarded_pumps=1, lanes_completed=done)


def phase_sharded_kernels(torch, mgr, kept):
    """The DBS kernels' calls kept from the sharded byte API (S*B lanes
    over the flattened (S*(E+1), 32, 4096) pool, rows offset by s*(E+1)),
    over replica 0's own pool: the read kernel bit for bit against its
    plain version and timed as in phase 6; then the write kernel's calls
    applied in turn to the pool and to a copy of it (kernel and plain
    version), equal bit for bit, and timed as in phase 3 (the library
    yardstick: ``index_copy_`` of the composed live rows)."""
    reads, writes = kept["dbs_rw_read"], kept["dbs_rw_write"]
    if not reads or not writes:
        raise AssertionError("no sharded kernel inputs were kept")
    pool0 = mgr.engine.backend.pools[0]
    pool = pool0.view(-1, PAGE_BLOCKS, BLOCK)
    rd = read_parity(torch, pool, reads)
    # the kept reads are mostly holes (a lane reads through one replica's
    # launch): a dense batch of S*B lanes over every shard's mapped rows
    # (offset by s*(E+1)), one lane in 16 a hole, holds the offset rows
    s_n, rows_per = pool0.shape[0], pool0.shape[1]
    table = mgr.engine.backend.states[0].table
    mapped = torch.cat([torch.unique(table[x][table[x] >= 0]).long()
                        + x * rows_per for x in range(s_n)])
    g = torch.Generator(device=pool.device).manual_seed(SEED)
    lanes_d = s_n * BATCH
    dense = []
    for _ in range(DENSE_READ_CALLS):
        pick = torch.randint(0, mapped.numel(), (lanes_d,), generator=g,
                             device=pool.device)
        hole = torch.rand(lanes_d, generator=g, device=pool.device) < 1 / 16
        dense.append((torch.where(hole, -1, mapped[pick]).to(torch.int32),
                      torch.randint(0, PAGE_BLOCKS, (lanes_d,), generator=g,
                                    device=pool.device, dtype=torch.int32)))
    dn = read_parity(torch, pool, dense)
    emit(phase="kernel_parity", kernel="dbs_rw_read", width="sharded_dense",
         pool_shape=list(pool.shape), calls=len(dense), lanes=lanes_d,
         hole_lanes=dn["hole_lanes"],
         shards_read=int(torch.unique(torch.cat([e[e >= 0] for e, _ in dense])
                                      // rows_per).numel()),
         max_abs_err=dn["max_abs_err"], ms=dn["ms"], plain_ms=dn["plain_ms"],
         bound_ms=dn["bound_ms"], library_ms=dn["library_ms"], equal=True)
    wr = write_parity(torch, pool, writes)
    lanes = wr["resources"]["lanes"]
    emit(phase="kernel_parity", kernel="dbs_rw_write", width="sharded",
         pool_shape=list(pool.shape), shards=mgr.engine.pool.n_shards,
         lanes=lanes, calls=wr["calls"], rows_written=wr["rows_written"],
         max_abs_err=wr["max_abs_err"], ms=wr["ms"], bound_ms=wr["bound_ms"],
         library_ms=wr["library_ms"], equal=True)
    emit(phase="kernel_parity", kernel="dbs_rw_read", width="sharded",
         pool_shape=list(pool.shape), calls=len(reads), lanes=rd["lanes"],
         hole_lanes=rd["hole_lanes"], max_abs_err=rd["max_abs_err"],
         ms=rd["ms"], bound_ms=rd["bound_ms"], library_ms=rd["library_ms"],
         equal=True)
    write = {**_width_keys("sharded", wr), "sharded_width_lanes": lanes}
    read = {"sharded_width_ms": rd["ms"],
            "sharded_width_plain_ms": rd["plain_ms"],
            "sharded_width_bound_ms": rd["bound_ms"],
            "sharded_width_library_ms": rd["library_ms"],
            "sharded_width_max_abs_err": rd["max_abs_err"],
            "sharded_width_lanes": max(rd["lanes"]),
            "sharded_width_calls": len(reads),
            "sharded_width_bytes_per_call": rd["bytes_per_call"],
            "sharded_width_resources": rd["resources"],
            "sharded_dense_ms": dn["ms"], "sharded_dense_plain_ms":
            dn["plain_ms"], "sharded_dense_bound_ms": dn["bound_ms"],
            "sharded_dense_library_ms": dn["library_ms"],
            "sharded_dense_max_abs_err": dn["max_abs_err"],
            "sharded_dense_hole_share": sum(dn["hole_lanes"])
            / (lanes_d * len(dense))}
    return write, read


def check_scaling(res, floor=0.7, upto=4):
    """benchmarks/table3_shards.py ``check_scaling``, copied (that module
    imports JAX): S=1 at least ``floor`` x ``+fused``, and each S up to
    ``upto`` at least ``floor`` x the one before. Returns the problems."""
    problems = []
    sharded = res["+sharded"]
    if 1 in sharded and sharded[1] < res["+fused"] * floor:
        problems.append(f"+sharded S=1 ({sharded[1]:.0f} ops/s) < "
                        f"{floor:g}x +fused ({res['+fused']:.0f} ops/s)")
    ss = sorted(x for x in sharded if x <= upto)
    for lo, hi in zip(ss, ss[1:]):
        if sharded[hi] < sharded[lo] * floor:
            problems.append(f"+sharded S={hi} ({sharded[hi]:.0f} ops/s) < "
                            f"{floor:g}x S={lo} ({sharded[lo]:.0f} ops/s)")
    return problems


def sharded_s1_split(torch, pool, smi, n=SPLIT_CALLS):
    """Where the S=1 pool's time a pump goes, on Table III's S=1 pool after
    its run, for one batch of B lanes (half writes) over its 8 volumes:
    host ms a call (a clock read around ``n`` calls, the card synchronised
    before and after) and aten ops a call of the pool's metadata step as
    it runs (unmapped at S=1), of the same step under ``torch.func.vmap``
    (how a mapped S runs it), and of the metadata ``+fused`` runs
    (``fused.step_meta`` with no health mask, one ``read_resolve``); then
    of the pool's routed reads (R launches and their select chain) against
    one read launch of the same lanes. Nothing is written back."""
    from functools import partial
    import torch.utils._pytree as pytree
    from torch.utils._python_dispatch import TorchDispatchMode
    from repro_torch.core import dbs
    from repro_torch.core.fused import FusedBatch, step_meta
    from repro_torch.core.ring import routed_read
    from repro_torch.core.sharded import _shard_step
    g = pool.backend
    states, pools, healthy = g.device_state()
    page_revs, rr, table = g.device_page_revs(), g._rr, pool.frontend.table
    dev = pool.device
    gen = torch.Generator(device=dev).manual_seed(SEED)
    i32 = dict(dtype=torch.int32, device=dev)
    lane = torch.arange(BATCH, **i32)
    batch = FusedBatch(
        want=torch.ones((1, BATCH), dtype=torch.bool, device=dev),
        is_write=(lane % 2 == 1)[None], volume=(lane % TABLE3_VOLUMES)[None],
        page=torch.randint(0, pool.cfg.max_pages, (1, BATCH), generator=gen,
                           **i32),
        block=(lane % 8)[None],
        payload=torch.ones((1, BATCH, BLOCK), device=dev),
        queue=torch.zeros((1, BATCH), **i32), step=torch.zeros((1,), **i32))
    mapped = torch.func.vmap(partial(_shard_step, null_backend=False,
                                     null_storage=False))
    t1, st1, pr1, b1 = pytree.tree_map(lambda x: x[0],
                                       (table, states, page_revs, batch))

    def fused_meta():
        out = step_meta(t1, st1, pr1, b1)
        return out, dbs.read_resolve(out[1][0], b1.volume, b1.page)
    routes = pool._meta(table, states, page_revs, batch, rr, healthy)[5]
    one_route = routes[0]
    for r in routes[1:]:
        one_route = torch.maximum(one_route, r)     # -1 off its replica
    calls = {
        "pool_step_unmapped": lambda: pool._meta(table, states, page_revs,
                                                 batch, rr, healthy),
        "pool_step_vmapped": lambda: mapped(table, states, page_revs, batch,
                                            rr, healthy),
        "fused_step_meta": fused_meta,
        "routed_reads": lambda: routed_read(pool._kern, pools, routes,
                                            batch.block, batch.payload),
        "one_read": lambda: pool._kern.read_stacked(pools[0], one_route,
                                                    batch.block)}

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += 1
            return func(*args, **(kwargs or {}))
    host_ms, aten_ops = {}, {}
    for name, f in calls.items():
        f()
        with Count() as c:
            f()
        aten_ops[name] = c.n
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(n):
            f()
        torch.cuda.synchronize()
        host_ms[name] = (time.perf_counter() - t) / n * 1e3
    emit(phase="sharded_s1_split", calls=n, lanes=BATCH, host_ms=host_ms,
         aten_ops=aten_ops, card=smi)
    return host_ms


def phase_table3(torch, args, dev, smi):
    """Table III (benchmarks/table3_shards.py's protocol on the request
    API, ``full_engine`` row): rounds of 2048 4 KiB requests, half writes,
    over 8 volumes, until 0.5 s of timed drains; ``+fused`` against
    ``+sharded`` at S = 1, 2, 4 and 8, all at the main path's 12288
    extents in total (E = 12288 / S a shard). The reference's
    ``check_scaling`` verdict is printed, not enforced. At every S the
    DBS kernels' launch counters must give 3 write launches a write pump
    and 3 read launches a pump (one a replica). Then the write routing
    (``_route_writes``, O(lanes^2)) is timed alone on the card, in a CUDA
    graph, on batches of 64, 256 and 512 lanes (S = 1, 4, 8)."""
    from repro_torch.core.dbs import WriteOps
    from repro_torch.kernels.dbs import rw_kernel
    from repro_torch.kernels.dbs.ops import _route_writes
    from repro_torch.kernels.timing import graph_ms
    res = {"+fused": None, "+sharded": {}}
    windows, pumps, per_pump = {}, {}, {}
    for column, n_sh in [("+fused", None)] + [("+sharded", x)
                                              for x in TABLE3_SHARDS]:
        kw = {} if n_sh is None else dict(n_shards=n_sh)
        eng = ladder_engine(torch, column, "full_engine", dev, args, **kw)
        rw_kernel.reset_counts()
        ops, seconds, rounds = measure_engine(torch, eng, LAYER_OPS[False],
                                              n_volumes=TABLE3_VOLUMES)
        key = column if n_sh is None else f"S={n_sh}"
        windows[key] = dict(seconds=seconds, rounds=rounds)
        if n_sh is None:
            res["+fused"] = ops
        else:
            res["+sharded"][n_sh] = ops
            pool = eng.pool
            pumps[key] = pool.dispatches
            per_pump[key] = {
                "dbs_rw_write": rw_kernel.LAUNCHES["dbs_rw_write"]
                / pool.step_counts["step"],
                "dbs_rw_read": rw_kernel.LAUNCHES["dbs_rw_read"]
                / pool.dispatches}
            if per_pump[key] != {"dbs_rw_write": REPLICAS,
                                 "dbs_rw_read": REPLICAS}:
                raise AssertionError(f"{key}: launches a pump {per_pump}")
            if n_sh == 1:
                sharded_s1_split(torch, pool, smi)
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    route_ms = {}
    for lanes in (BATCH, SHARDS * BATCH, TABLE3_SHARDS[-1] * BATCH):
        g = torch.Generator(device=dev).manual_seed(lanes)
        rows = torch.randperm(2 * lanes, generator=g, device=dev)[:lanes]
        rows[lanes // 2:lanes // 2 + lanes // 8] = rows[:lanes // 8]
        cow = torch.rand(lanes, generator=g, device=dev) < 0.3
        ops = WriteOps(dst=rows.to(torch.int32),
                       cow_src=torch.where(cow, rows + 2 * lanes, -1).to(
                           torch.int32),
                       ok=torch.rand(lanes, generator=g, device=dev) < 0.9)
        blocks = torch.randint(0, PAGE_BLOCKS, (lanes,), generator=g,
                               device=dev, dtype=torch.int32)
        route_ms[lanes] = graph_ms(
            lambda: _route_writes(ops, PAGE_BLOCKS, blocks, 4 * lanes), 1)
    problems = check_scaling(res)
    emit(phase="table3_shards", row="full_engine",
         requests_a_round=LAYER_OPS[False], volumes=TABLE3_VOLUMES,
         total_extents=args.n_extents, ops_per_s={
             "+fused": res["+fused"],
             "+sharded": {str(k): v for k, v in res["+sharded"].items()}},
         speedup_over_fused={str(k): v / res["+fused"]
                             for k, v in res["+sharded"].items()},
         pumps_incl_warmup=pumps, windows=windows,
         launches_a_pump=per_pump,
         route_writes_ms={str(k): v for k, v in route_ms.items()},
         check_scaling="ok" if not problems else problems, card=smi)
    return res


def phase_shard_failover(torch, args, dev, smi, trace_ops):
    """The sharded byte API's trace with shard 1's replica 1 failed (after
    a flush) halfway through it, writes going on; then that slice alone is
    rebuilt, timed between two synchronisations, against the bound of its
    moved rows (each read once from the donor and written once, at 3.35
    TB/s). Checked: the shard's replicas agree and the rebuilt slice equals
    its donor on every mapped row; no message and no row of shards 0, 2
    and 3 moved on any replica's link; with shard 1's replicas 0 and 2
    failed, every block written to its volume reads back right from the
    rebuilt replica alone; rebuilding those two then moves no row."""
    sick = FAILED_SHARD
    mgr, launches, _steps, kept, out = phase_main(
        torch, args, dev, smi, column="shard_failover",
        fail_after=trace_ops // 2, fail_shard=sick, **sharded_config(args))
    g = mgr.engine.backend
    row_bytes = PAGE_BLOCKS * BLOCK * 4
    sent0 = [dict(t.sent_by_shard) for t in g.transports]
    rows0 = [dict(t.pages_moved_by_shard) for t in g.transports]
    moved0 = g.transports[1].pages_moved
    torch.cuda.synchronize()
    t = time.perf_counter()
    mgr.engine.control("rebuild", shard=sick, replica=1)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t
    moved = g.transports[1].pages_moved - moved0
    for tr, s0, r0 in zip(g.transports, sent0, rows0):
        for sh in range(g.n_shards):
            if sh != sick and (tr.sent_by_shard[sh] != s0.get(sh, 0)
                               or tr.pages_moved_by_shard[sh]
                               != r0.get(sh, 0)):
                raise AssertionError(f"the rebuild of shard {sick} moved a "
                                     f"message or row of shard {sh}")
    if not g.consistent(sick) or moved <= 0:
        raise AssertionError(f"shard {sick}: replicas disagree after the "
                             f"rebuild (moved {moved} rows)")
    t0 = g.states[0].table[sick]
    if not torch.equal(g.states[1].table[sick], t0):
        raise AssertionError("the rebuilt slice's extent map differs")
    rows = torch.unique(t0[t0 >= 0]).long()
    for i in range(0, rows.numel(), 1024):
        part = rows[i:i + 1024]
        if not torch.equal(g.pools[1][sick][part], g.pools[0][sick][part]):
            raise AssertionError("the rebuilt slice differs from its donor")
    mgr.engine.control("fail", shard=sick, replica=0)
    mgr.engine.control("fail", shard=sick, replica=2)
    shadow = kept["shadow"]
    vols = [v for v in kept["volumes"] if v.vid % g.n_shards == sick]
    futs = [(v.pread(ab * BLOCK, BLOCK), v, ab) for v in vols
            for (vid, ab) in sorted(shadow.blocks) if vid == v.vid]
    mgr.flush()
    for fut, v, ab in futs:
        if fut.result() != shadow.read(v.vid, ab * BLOCK, BLOCK):
            raise AssertionError("the rebuilt slice read wrong bytes")
    for i in (0, 2):                             # nothing written: no rows
        before = sum(tr.pages_moved for tr in g.transports)
        mgr.engine.control("rebuild", shard=sick, replica=i)
        if sum(tr.pages_moved for tr in g.transports) != before:
            raise AssertionError(f"rebuilding replica {i} moved rows")
    if not g.consistent() or not g.healthy.all():
        raise AssertionError("the replicas disagree after the rebuilds")
    del kept
    emit(phase="shard_failover", shards=g.n_shards, failed_shard=sick,
         ops=out["ops"], failed_at_op=out["replica_1_failed_at_op"],
         trace_ops_per_s=out["ops_per_s"], seconds=seconds,
         extents_moved=moved, bytes_moved=moved * row_bytes,
         bound_ms=2 * moved * row_bytes / HBM_BYTES_PER_S * 1e3,
         bound_by="bytes: each moved row read once from the donor and "
                  "written once to the target, at 3.35 TB/s",
         messages_by_shard=[dict(tr.sent_by_shard) for tr in g.transports],
         rows_by_shard=[dict(tr.pages_moved_by_shard)
                        for tr in g.transports],
         blocks_checked_on_replica_1_alone=len(futs),
         mapped_rows_of_shard=int(rows.numel()), launches=launches, card=smi)
    mgr.close()


def _tokens_match(outs, want, margin_of, what, tie_margin=None):
    """Each request's tokens against ``want``'s under the TIE_MARGIN rule
    (phase 15; ``tie_margin`` in its place where given): where they first
    differ, the step's top-2 logit margin must be under it, and the
    request's later steps are not compared. Returns the number of such
    near ties."""
    tie_margin = TIE_MARGIN if tie_margin is None else tie_margin
    ties = 0
    for rid, got in outs.items():
        ref = want[rid]
        if len(got) != len(ref):
            raise AssertionError(f"{what}: request {rid} made {len(got)} "
                                 f"tokens, not {len(ref)}")
        for t, (a, b) in enumerate(zip(got, ref)):
            if a != b:
                if margin_of[(rid, t)] >= tie_margin:
                    raise AssertionError(f"{what}: request {rid} step {t}: "
                                         f"token {a}, not {b}")
                ties += 1
                break
    return ties


def _margin_np(np, logits) -> float:
    """The top-2 margin of one step's recorded logits (TIE_MARGIN rule);
    codebook 0's on a multi-codebook net, whose token it is."""
    logits = np.asarray(logits)
    top = np.sort(logits if logits.ndim == 1 else logits[0])[-2:]
    return float(top[1] - top[0])


def _margin_step(torch, eng, step, margins):
    """``step`` (an engine's decode program) wrapped to append, each call,
    every slot's top-2 logit margin (one ``topk`` on the card) with the
    (request, token index) it decided to ``margins`` (TIE_MARGIN rule)."""
    def run(*a, **k):
        out = step(*a, **k)
        logits = out[0] if out[0].dim() == 2 else out[0][:, 0]  # codebook 0
        top = torch.topk(logits, 2, dim=-1).values.float()   # on the card
        who = [(g.req_id, len(g.out_tokens)) if g is not None else None
               for g in map(eng.live_by_slot, range(eng.n_slots))]
        margins.append((top[:, 0] - top[:, 1], who))
        return out
    return run


def _margin_map(torch, margins):
    """``{(request, token index): top-2 margin}`` of ``_margin_step``'s
    record, read back once."""
    if not margins:
        return {}
    got = torch.stack([m for m, _ in margins]).cpu().numpy()
    return {key: float(got[i, j]) for i, (_, who) in enumerate(margins)
            for j, key in enumerate(who) if key is not None}


def phase_serve_sharded(torch, dev, smi, cfg, params, prompts, want):
    """Zero-copy serving on the sharded KV store: ``kv_backend="sharded",
    kv_shards=2`` (each shard with the fused run's 1032 extents), 2 KV
    replicas, otherwise phase 9's engine and its 16 requests. Tokens equal
    the fused run's (``want``) under the TIE_MARGIN rule (the decode
    program's top-2 margins are taken on the card, one ``topk`` a step);
    the paged kernel reads the flattened (2*(E+1))-row pool; the replicas
    agree, nothing leaks. Then four of the requests again, admitted with
    shard 0's replica 1 failed (their prompts' K/V pumps skip it), which is
    rebuilt after 6 steps, mid-decode (the delta and the live-row resync),
    and shard 0's replica 0 failed after it: the rebuilt replica alone
    serves the rest, to the fused run's tokens."""
    from repro_torch.core import dbs
    from repro_torch.kernels.dbs import rw_kernel
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.paged_attention import kernel as pk
    from repro_torch.serving import engine as serving
    from repro_torch.serving.engine import GenRequest
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    eng = _serve_engine(torch, cfg, params, dev, kv_backend="sharded",
                        kv_shards=SERVE_SHARDS)
    clock = {"prefill": 0.0, "pumps": 0.0, "decode": 0.0}
    margins, pool_rows = [], set()
    inner = {"prefill": eng._prefill_one_zero, "pump": eng._pump_writes,
             "step": eng._step_fn,
             "paged": serving.paged_attention_pool_fwd}

    def timed(name, fn):
        def run(*a, **k):
            t = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            clock[name] += time.perf_counter() - t
            return out
        return run

    def paged(q, pool, table, lengths, **k):
        pool_rows.add(int(pool.shape[0]))
        return inner["paged"](q, pool, table, lengths, **k)

    eng._prefill_one_zero = timed("prefill", inner["prefill"])
    eng._pump_writes = timed("pumps", inner["pump"])
    eng._step_fn = timed("decode", _margin_step(torch, eng, inner["step"],
                                                margins))
    serving.paged_attention_pool_fwd = paged
    for mod in (rw_kernel, pk, fk):
        mod.reset_counts()
    try:
        t0 = time.perf_counter()
        for rid, pr in enumerate(prompts):
            eng.submit(GenRequest(req_id=rid, prompt=pr, max_new=SERVE_NEW))
        outs = eng.run(max_steps=10 * SERVE_NEW * SERVE_REQUESTS)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = {**rw_kernel.LAUNCHES, **pk.LAUNCHES, **fk.LAUNCHES}
        plain = {**rw_kernel.PLAIN_CALLS, **pk.PLAIN_CALLS,
                 **fk.PLAIN_CALLS}
        peak = torch.cuda.max_memory_allocated(dev)
        ties = _tokens_match(outs, want, _margin_map(torch, margins),
                             "sharded serving")
        n_e = eng.volumes.engine.cfg.n_extents
        if pool_rows != {SERVE_SHARDS * (n_e + 1)}:
            raise AssertionError(f"the paged kernel read pools of "
                                 f"{pool_rows} rows")
        if min(launches.values()) <= 0 or any(plain.values()):
            raise AssertionError(f"launches {launches}, plain {plain}")
        eng.volumes.flush()
        g = eng.volumes.engine.backend
        pools = eng.volumes.device_pools()
        if not g.consistent() or not torch.equal(pools[0][:-1],
                                                 pools[1][:-1]):
            raise AssertionError("the sharded KV replicas disagree")
        del pools
        st = eng.state
        if bool((st.extent_owner >= 0).any() | (st.vol_head >= 0).any()):
            raise AssertionError("sharded serving leaked volumes or extents")
        gen_tokens = SERVE_REQUESTS * SERVE_NEW
        emit(phase="serve_path", model=SERVE_MODEL, config=dict(
            kv_backend="sharded", kv_shards=SERVE_SHARDS, kv_replicas=2,
            n_slots=8, max_len=2048, n_queues=2, kernel="cuda",
            attn_impl="cuda", dtype="float32", n_extents_a_shard=n_e),
            requests=SERVE_REQUESTS, generated_tokens=gen_tokens,
            run_seconds=run_s, prefill_seconds=clock["prefill"],
            pump_seconds=clock["pumps"], decode_seconds=clock["decode"],
            decode_tokens_per_s=gen_tokens / clock["decode"],
            tokens_per_s=gen_tokens / run_s, tokens_equal_fused=ties == 0,
            near_ties=ties, paged_pool_rows=sorted(pool_rows),
            launches=launches, plain_calls=plain, max_memory_allocated=peak,
            card=smi)

        # mid-decode per-shard failover; then the rebuilt replica alone
        margins.clear()
        base = 1000
        eng.control("fail", shard=0, replica=1)
        for rid in range(SERVE_REBUILD_REQUESTS):
            eng.submit(GenRequest(req_id=base + rid, prompt=prompts[rid],
                                  max_new=SERVE_NEW))
        for _ in range(6):
            eng.step()
        moved0 = dict(g.transports[1].pages_moved_by_shard)
        torch.cuda.synchronize()
        t = time.perf_counter()
        eng.control("rebuild", shard=0, replica=1)
        torch.cuda.synchronize()
        rebuild_s = time.perf_counter() - t
        moved = {k: v - moved0.get(k, 0)
                 for k, v in g.transports[1].pages_moved_by_shard.items()
                 if v != moved0.get(k, 0)}
        eng.control("fail", shard=0, replica=0)
        if eng._attn != 1 or set(moved) != {0}:
            raise AssertionError(f"attending replica {eng._attn}; rows "
                                 f"moved by shard {moved}")
        outs2 = eng.run(max_steps=4 * SERVE_NEW)
        got = {rid - base: toks for rid, toks in outs2.items()
               if rid >= base}
        mm = {(rid - base, t): m for (rid, t), m in
              _margin_map(torch, margins).items() if rid >= base}
        ties2 = _tokens_match(got, want, mm, "the rebuilt replica alone")
        eng.control("rebuild", shard=0, replica=0)
        if not g.consistent() or not g.healthy.all():
            raise AssertionError("the replicas disagree after the rebuilds")
        on0 = [v % SERVE_SHARDS == 0 for v in
               (eng.live[base + r].volume for r in
                range(SERVE_REBUILD_REQUESTS))]
        emit(phase="serve_sharded_rebuild", requests=SERVE_REBUILD_REQUESTS,
             sessions_on_shard_0=sum(on0), failed_before_admission=True,
             rebuilt_after_steps=6, rebuild_seconds=rebuild_s,
             rows_moved_by_shard=moved, attended_replica_after=1,
             tokens_equal_fused=ties2 == 0, near_ties=ties2, card=smi)
    finally:
        serving.paged_attention_pool_fwd = inner["paged"]
        eng.volumes.close()
    return launches


# ---------------------------------------------------------------------------
# the ring slice: the opcode-dispatched step, in-band control, storage
# functions
# ---------------------------------------------------------------------------
def _rot_table(np):
    """T[r, b] = rotl32(b + 1, r) as uint64, r in 0..31, b in 0..255."""
    r = np.arange(32, dtype=np.uint64)[:, None]
    v = np.arange(1, 257, dtype=np.uint64)[None, :]
    return ((v << r) | (v >> ((32 - r) % 32))) & np.uint64(0xFFFFFFFF)


class ByteSpec:
    """The storage functions' byte spec (repro_torch/compute/functions.py)
    in numpy over a volume that is zeros but for the trace's written
    blocks (``Shadow``): the range fold is linear in XOR, so it is the fold
    of an all-zero volume (from per-rotation position counts) XOR the
    written bytes' change against zeros; no 1 GiB host array is built."""

    def __init__(self, np, shadow, vid, n_pages):
        self.np = np
        self.n_pages = n_pages
        self.T = _rot_table(np)
        blocks = sorted(ab for (v, ab) in shadow.blocks if v == vid)
        self.ab = np.asarray(blocks, np.int64)
        self.data = (np.frombuffer(b"".join(shadow.blocks[(vid, ab)]
                                            for ab in blocks), np.uint8)
                     .reshape(len(blocks), BLOCK) if blocks else
                     np.zeros((0, BLOCK), np.uint8))
        page_bytes = PAGE_BLOCKS * BLOCK
        # positions of a page with j % 31 == k, k in 0..30
        self.per_k = np.bincount(np.arange(page_bytes) % 31, minlength=31)

    def i32(self, x):
        x = int(x) & 0xFFFFFFFF
        return x - (1 << 32) if x >= (1 << 31) else x

    def checksum(self, p0, cnt):
        np = self.np
        p1 = min(p0 + cnt, self.n_pages)
        pages = np.arange(max(p0, 0), p1)
        # zeros: byte 0 contributes rotl32(1, r) at rotation r, so only
        # the parity of each rotation's count matters
        r = (np.arange(31)[None, :] + (pages % 31)[:, None]) % 32
        par = np.bincount(r.ravel(), weights=np.broadcast_to(
            self.per_k, r.shape).ravel(), minlength=32).astype(np.int64) % 2
        total = 0
        for rot in np.nonzero(par)[0]:
            total ^= int(self.T[rot, 0])
        sel = (self.ab // PAGE_BLOCKS >= max(p0, 0)) & \
            (self.ab // PAGE_BLOCKS < p1)
        ab, data = self.ab[sel], self.data[sel]
        for i in range(0, len(ab), 2048):
            a, d = ab[i:i + 2048], data[i:i + 2048]
            j = (a % PAGE_BLOCKS)[:, None] * BLOCK + np.arange(BLOCK)[None]
            rot = (j % 31 + ((a // PAGE_BLOCKS) % 31)[:, None]) % 32
            total ^= int(np.bitwise_xor.reduce(
                (self.T[rot, d] ^ self.T[rot, 0]).ravel()))
        return self.i32(total)

    def _match(self, arg):
        return self.data != 0 if arg < 0 else self.data == (arg & 0xFF)

    def scan_count(self, arg):
        n = int(self._match(arg).sum())
        if arg == 0:          # every byte of every hole block matches
            n += (self.n_pages * PAGE_BLOCKS - len(self.ab)) * BLOCK
        return n

    def filter_pages(self, arg, d=BLOCK):
        np = self.np
        if arg == 0:
            raise ValueError("the spec's filter skips arg 0 (holes match)")
        hit = self._match(arg).any(1)
        pages = np.unique(self.ab[hit] // PAGE_BLOCKS)
        return len(pages), [int(p) for p in pages[:d]]

    def block(self, ab):
        i = int(self.np.searchsorted(self.ab, ab))
        if i < len(self.ab) and self.ab[i] == ab:
            return self.data[i].tobytes()
        return bytes(BLOCK)


def phase_compute(torch, smi, mgr, kept, path):
    """The five storage functions on the main volume at full width through
    ``Volume.compute``: in-band on the ring (one COMPUTE request a call),
    per call on ``fused`` (``device_compute``). ``checksum`` and
    ``scan_count`` over the whole 1 GiB range and a sub-range, ``filter_
    pages``, ``verify_on_read`` of a written block and of a hole,
    ``compare_and_write`` once not matching and once matching (then the
    block reads back committed). Each result equals the numpy byte spec
    over the trace's shadow (``ByteSpec``, the port's own ``np_blocksum``
    for the block functions). ms a call (between synchronisations), bytes
    read (the volume's mapped blocks), the bound of a full-range fold (the
    volume's float32 lanes read once over 3.35 TB/s) and the peak memory
    the calls add to the pools."""
    import numpy as np
    from repro_torch.compute.functions import np_blocksum
    from repro_torch.kernels.dbs import copy_kernel, rw_kernel
    vol = kept["volumes"][0]
    shadow = kept["shadow"]
    mgr.flush()
    before = {**rw_kernel.LAUNCHES, **copy_kernel.LAUNCHES}
    n_pages = mgr.capacity // mgr.page_bytes
    spec = ByteSpec(np, shadow, vol.vid, n_pages)
    table = mgr.device_extent_map()[vol.vid]
    mapped = int((table >= 0).sum())
    lane_bytes = n_pages * PAGE_BLOCKS * BLOCK * 4
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    calls, results = {}, {}

    def run(name, *a, **k):
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = vol.compute(*a, **k).result()
        torch.cuda.synchronize()
        calls.setdefault(name, []).append((time.perf_counter() - t) * 1e3)
        return res

    def check(name, got, want):
        results[name] = dict(value=got.value, status=got.status)
        if (got.value, got.status) != want:
            raise AssertionError(f"{path} {name}: {(got.value, got.status)}"
                                 f" against the spec's {want}")

    pby = mgr.page_bytes
    check("checksum", run("checksum", "checksum"),
          (spec.checksum(0, n_pages), 0))
    p0, cnt = n_pages // 8, n_pages // 4
    check("checksum_sub", run("checksum", "checksum", p0 * pby, cnt * pby),
          (spec.checksum(p0, cnt), 0))
    for arg in (7, -1, 0):
        check(f"scan_count_{arg}", run("scan_count", "scan_count", arg=arg),
              (spec.scan_count(arg), 0))
    for arg in (7, -1):
        got = run("filter_pages", "filter_pages", arg=arg)
        n, pages = spec.filter_pages(arg)
        check(f"filter_pages_{arg}", got, (n, 0))
        if got.pages() != pages:
            raise AssertionError(f"{path} filter_pages {arg}: pages differ")
    live = np.nonzero(spec.data.any(1))[0]      # a block with data
    ab = int(spec.ab[live[len(live) // 2]])
    cur = spec.block(ab)
    got = run("verify_on_read", "verify_on_read", ab * BLOCK,
              arg=np_blocksum(cur))
    check("verify_on_read", got, (np_blocksum(cur), 0))
    if got.data() != cur:
        raise AssertionError(f"{path} verify_on_read: wrong bytes")
    hole = next(b for b in range(n_pages * PAGE_BLOCKS)
                if (vol.vid, b) not in shadow.blocks)
    got = run("verify_on_read", "verify_on_read", hole * BLOCK)
    check("verify_on_read_hole", got, (np_blocksum(bytes(BLOCK)), 0))
    new = bytes((i * 13 + 5) % 256 for i in range(BLOCK))
    want = np_blocksum(cur)
    bad = want + 1 if want < 2 ** 31 - 1 else want - 1
    check("compare_and_write_miss", run(
        "compare_and_write", "compare_and_write", ab * BLOCK, arg=bad,
        data=new), (want, 1))
    check("compare_and_write_match", run(
        "compare_and_write", "compare_and_write", ab * BLOCK, arg=want,
        data=new), (want, 0))
    if vol.read(ab * BLOCK, BLOCK) != new:
        raise AssertionError(f"{path} compare_and_write did not commit")
    shadow.write(vol.vid, ab * BLOCK, new)
    torch.cuda.synchronize()
    launches = {k: v - before[k] for k, v in
                {**rw_kernel.LAUNCHES, **copy_kernel.LAUNCHES}.items()}
    peak = torch.cuda.max_memory_allocated() - base
    if peak > 2 << 30:
        raise AssertionError(f"{path}: the storage functions took {peak} "
                             "bytes over the pools")
    emit(phase="storage_functions", path=path, volume_bytes=mgr.capacity,
         written_blocks=len(spec.ab), mapped_pages=mapped,
         results=results,
         ms={k: float(np.median(v)) for k, v in calls.items()},
         calls={k: len(v) for k, v in calls.items()},
         full_range_bytes_read=mapped * PAGE_BLOCKS * BLOCK * 4,
         full_range_bound_ms=lane_bytes / HBM_BYTES_PER_S * 1e3,
         bound_by="bytes: the volume's float32 lanes read once at 3.35 TB/s",
         peak_bytes_over_pools=peak, launches=launches, card=smi)
    return launches


def phase_no_sync_ring(torch, mgr):
    """One ring pump with data and control lanes (32 writes, a snapshot,
    an unmap and a clone of the main volume) and one with compute lanes (a
    whole-volume checksum, a verify_on_read and a committing
    compare_and_write) under sync-debug "error", from ``pump_async`` to
    the recorded event."""
    import numpy as np
    from repro_torch.compute.functions import np_blocksum
    from repro_torch.core.frontend import Request
    pool = mgr.engine.pool
    vid = 0
    blk = mgr.open(vid).read(0, BLOCK)
    rid = lambda: mgr._rid(vid)
    batches = [
        [Request(req_id=rid(), kind="write", volume=vid, page=i, block=3,
                 payload=np.full(BLOCK, i, np.float32)) for i in range(32)]
        + [Request(req_id=rid(), kind="snapshot", volume=vid),
           Request(req_id=rid(), kind="unmap", volume=vid,
                   page=mgr.capacity // mgr.page_bytes - 1),
           Request(req_id=rid(), kind="clone", volume=vid)],
        [Request(req_id=rid(), kind="compute", volume=vid, fn="checksum",
                 page=0, block=mgr.capacity // mgr.page_bytes),
         Request(req_id=rid(), kind="compute", volume=vid,
                 fn="verify_on_read", page=0, block=1),
         Request(req_id=rid(), kind="compute", volume=vid,
                 fn="compare_and_write", page=0, block=0,
                 arg=np_blocksum(blk), payload=np.zeros(BLOCK, np.float32))]]
    mgr.engine.backend.device_state()     # the health mask, cached
    done = []
    for batch in batches:
        for r in batch:
            pool.submit(r)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            pending = pool.pump_async()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        done.append(pool._complete(pending))
        if done[-1] != len(batch) or any(r.status != 0 for r in batch):
            raise AssertionError("a guarded ring pump did not complete its "
                                 "lanes")
    clone = batches[0][-1].result
    mgr.delete(clone)
    if mgr.open(vid).read(0, BLOCK) != bytes(BLOCK):
        raise AssertionError("the guarded compare_and_write did not commit")
    emit(phase="no_sync", path="ring", guarded_pumps=2,
         lanes_completed=done, control_lanes=3, compute_lanes=3)


def phase_ring_shards(torch, args, dev, smi, trace_ops):
    """The ring at S=4 on the sharded byte API's geometry and cut trace,
    shard 1's replica 1 failed by an in-band FAIL request after half the
    trace's ops and rebuilt by an in-band REBUILD request after three
    quarters (the step copies the donor's slice, state, pool and
    watermarks, in place), every read checked, every shard's replicas
    equal at the end. The rebuild pump's time against its bound (the
    slice's pool bytes read once and written once over 3.35 TB/s) and the
    phase's peak memory."""
    cfg = dict(sharded_config(args), backend="ring")
    mgr, launches, _steps, kept, out = phase_main(
        torch, args, dev, smi, column="+ring S=4",
        fail_after=trace_ops // 2, rebuild_after=3 * trace_ops // 4,
        fail_shard=FAILED_SHARD, **cfg)
    g = mgr.engine.backend
    slice_bytes = g.pools[1][FAILED_SHARD].numel() * 4
    if not g.healthy.all() or not g.consistent():
        raise AssertionError("the in-band rebuild left the ring unhealthy")
    del kept
    mgr.close()
    emit(phase="ring_shards", shards=SHARDS, failed_shard=FAILED_SHARD,
         ops=out["ops"], ops_per_s=out["ops_per_s"],
         failed_at_op=out["replica_1_failed_at_op"],
         rebuilt_at_op=out["replica_1_rebuilt_at_op"],
         rebuild_ms=out["rebuild_seconds"] * 1e3,
         rebuild_bound_ms=2 * slice_bytes / HBM_BYTES_PER_S * 1e3,
         bound_by="bytes: the slice's pool read once from the donor and "
                  "written once, at 3.35 TB/s",
         slice_pool_bytes=slice_bytes,
         max_memory_allocated=out["max_memory_allocated"],
         launches=launches, card=smi)
    return out


def phase_serve_ring(torch, dev, smi, cfg, params, prompts, want):
    """Zero-copy serving on the ring: ``kv_backend="ring"``, 2 KV
    replicas, phase 9's engine and its first four requests. The KV writes
    ride the ring's pumps, the sessions' deletes its in-band control.
    Tokens equal the fused run's under the TIE_MARGIN rule; the replicas
    agree; nothing leaks."""
    from repro_torch.kernels.dbs import rw_kernel
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.paged_attention import kernel as pk
    from repro_torch.serving.engine import GenRequest
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    eng = _serve_engine(torch, cfg, params, dev, kv_backend="ring")
    margins = []
    eng._step_fn = _margin_step(torch, eng, eng._step_fn, margins)
    for mod in (rw_kernel, pk, fk):
        mod.reset_counts()
    try:
        t0 = time.perf_counter()
        for rid in range(SERVE_RING_REQUESTS):
            eng.submit(GenRequest(req_id=rid, prompt=prompts[rid],
                                  max_new=SERVE_NEW))
        outs = eng.run(max_steps=10 * SERVE_NEW * SERVE_RING_REQUESTS)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = {**rw_kernel.LAUNCHES, **pk.LAUNCHES, **fk.LAUNCHES}
        plain = {**rw_kernel.PLAIN_CALLS, **pk.PLAIN_CALLS,
                 **fk.PLAIN_CALLS}
        ties = _tokens_match(outs, {r: want[r] for r in outs},
                             _margin_map(torch, margins), "ring serving")
        if min(launches.values()) <= 0 or any(plain.values()):
            raise AssertionError(f"launches {launches}, plain {plain}")
        eng.volumes.flush()
        g = eng.volumes.engine.backend
        pools = eng.volumes.device_pools()
        if not g.consistent() or not torch.equal(pools[0][:-1],
                                                 pools[1][:-1]):
            raise AssertionError("the ring's KV replicas disagree")
        del pools
        st = eng.state
        if bool((st.extent_owner >= 0).any() | (st.vol_head >= 0).any()):
            raise AssertionError("ring serving leaked volumes or extents")
        gen = SERVE_RING_REQUESTS * SERVE_NEW
        emit(phase="serve_path", model=SERVE_MODEL, config=dict(
            kv_backend="ring", kv_replicas=2, n_slots=8, max_len=2048,
            n_queues=2, kernel="cuda", attn_impl="cuda", dtype="float32"),
            requests=SERVE_RING_REQUESTS, generated_tokens=gen,
            run_seconds=run_s, tokens_per_s=gen / run_s,
            tokens_equal_fused=ties == 0, near_ties=ties,
            steps_by_signature={"+".join(k): v for k, v in
                                eng.volumes.engine.pool.step_counts.items()},
            launches=launches, plain_calls=plain,
            max_memory_allocated=torch.cuda.max_memory_allocated(dev),
            card=smi)
    finally:
        eng.volumes.close()
    return launches


# ---------------------------------------------------------------------------
# phases 8l-8n: the durability slice on the block device
# ---------------------------------------------------------------------------
def durability_config(args, **kw):
    """The main path's manager geometry (3 replicas, 4 KiB blocks, 32-block
    extent rows, the 1 GiB volume, fused on the cuda kernels)."""
    config = dict(backend="fused", kernel="cuda", n_replicas=REPLICAS,
                  payload_elems=BLOCK, page_blocks=PAGE_BLOCKS,
                  max_pages=args.max_pages, n_extents=args.n_extents,
                  max_volumes=16, batch=BATCH, n_slots=256, n_queues=4)
    config.update(kw)
    return config


def fs_of(path):
    """The mount point holding ``path`` and its filesystem type, from
    /proc/mounts (the longest mount point that prefixes the path)."""
    real, best, kind = os.path.realpath(path), "", "unknown"
    try:
        with open("/proc/mounts") as f:
            for ln in f:
                parts = ln.split()
                mnt = parts[1]
                if ((real == mnt or real.startswith(mnt.rstrip("/") + "/"))
                        and len(mnt) > len(best)):
                    best, kind = mnt, parts[2]
    except OSError:
        pass
    return best, kind


class PumpCounter:
    """Counts the pumps that did work on a manager's backend, until
    ``restore()``."""

    def __init__(self, mgr):
        self.impl = mgr.engine.impl
        self.inner = self.impl.pump
        self.n = 0

        def pump():
            got = self.inner()
            self.n += got > 0
            return got
        self.impl.pump = pump

    def restore(self):
        self.impl.pump = self.inner


def write_stream(mgr, vid, payloads, n_writes, shift, written,
                 on_half=None):
    """The journal phase's stream: ``n_writes`` 4 KiB writes at scattered
    block offsets (a stride of 7919 blocks over the volume), a flush every
    DUR_FLUSH_EVERY and a durable flush at the end; ``written`` maps each
    block to its bytes. ``on_half`` runs after the flush at the middle.
    Returns the seconds the stream took."""
    n_blocks = mgr.capacity // BLOCK
    t0 = time.perf_counter()
    for i in range(n_writes):
        ab = (i * 7919) % n_blocks
        data = payloads[(i + shift) % len(payloads)]
        mgr.pwrite(vid, ab * BLOCK, data)
        written[ab] = data
        if (i + 1) % DUR_FLUSH_EVERY == 0:
            mgr.flush()
            if on_half is not None and i + 1 == n_writes // 2:
                on_half()
    mgr.flush(durable=True)
    return time.perf_counter() - t0


def mgr_digest(torch, mgr, vid):
    """``volume_digest`` of volume ``vid`` on a manager's first healthy
    replica (the fused group, or shard 0 of a one-shard ring)."""
    g = mgr.engine.backend
    if hasattr(g, "replicas"):
        r = g.replicas[g.healthy_indices()[0]]
        return volume_digest(torch, r.pool, r.state.table[vid])
    if g.n_shards != 1:
        raise ValueError("mgr_digest reads one-shard groups only")
    return volume_digest(torch, g.pools[0][0], g.states[0].table[0, vid])


def check_blocks(mgr, vid, written):
    """Read every written block back through the byte API; all must hold
    their bytes. Returns the blocks checked."""
    futs = [(mgr.pread(vid, ab * BLOCK, BLOCK), data)
            for ab, data in written.items()]
    mgr.flush()
    bad = sum(f.result() != data for f, data in futs)
    if bad:
        raise AssertionError(f"{bad} of {len(futs)} blocks read back wrong")
    return len(futs)


def tear_tail(path):
    """A crash mid-append: half a valid write record on the journal tail."""
    import numpy as np
    from repro_torch.core.transport import MSG_WRITE, WireMsg
    from repro_torch.durability.journal import encode_record
    rec = encode_record(10 ** 9, WireMsg(
        op=MSG_WRITE, volume=0, pages=np.asarray([0], np.int32),
        blocks=np.asarray([0], np.int32),
        payload=np.zeros((1, BLOCK), np.float32)))
    with open(path, "ab") as f:
        f.write(rec[:len(rec) // 2])


def replayed_blocks(path):
    from repro_torch.core.transport import MSG_WRITE
    from repro_torch.durability import read_journal
    return sum(len(m.pages) for _, m in read_journal(path).records
               if m.op == MSG_WRITE)


def phase_journal(torch, args, dev, smi, tmp):
    """8l: the same write stream with the journal on and off, interleaved,
    best of 3 after a short warm-up and a stream whose host syncs a pump
    are counted."""
    import numpy as np
    from repro_torch.core.blockdev import VolumeManager
    from repro_torch.kernels.dbs import copy_kernel, rw_kernel
    rng = np.random.default_rng(SEED + 21)
    payloads = [rng.integers(0, 256, BLOCK, dtype=np.uint8).tobytes()
                for _ in range(DUR_FLUSH_EVERY)]
    jp = os.path.join(tmp, "wal.dbsj")
    cfg = durability_config(args)
    for mod in (rw_kernel, copy_kernel):
        mod.reset_counts()
    on = VolumeManager(journal=jp, device=dev, **cfg)
    off = VolumeManager(device=dev, **cfg)
    vids, written, syncs, pumps = {}, {}, {}, {}
    for name, mgr in (("on", on), ("off", off)):
        vids[name] = mgr.create().vid
        written[name] = {}
        # a short warm-up first: one-time set-up (the first pinned
        # buffer, the kernels' first calls) must not land in a count
        write_stream(mgr, vids[name], payloads, 4 * DUR_FLUSH_EVERY, 0,
                     written[name])
        pc = PumpCounter(mgr)
        syncs[name] = count_syncs(torch, lambda: write_stream(
            mgr, vids[name], payloads, DUR_WRITES, 0, written[name]))
        pumps[name] = pc.n
        pc.restore()
    secs = {"on": [], "off": []}
    # where the journal's time goes: its group commits (encode, checksum,
    # one file write) and its fsyncs, timed inside the timed streams
    jn, spent = on._journal, {"append": 0.0, "sync": 0.0, "appends": 0}

    def timed(name, fn):
        def call(*a, **k):
            t = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                spent[name] += time.perf_counter() - t
                spent["appends"] += name == "append"
        return call
    jn.append_batch = timed("append", jn.append_batch)
    jn.sync = timed("sync", jn.sync)
    for rep in range(1, 4):
        for name, mgr in (("on", on), ("off", off)):
            torch.cuda.synchronize()
            secs[name].append(write_stream(mgr, vids[name], payloads,
                                           DUR_WRITES, rep, written[name]))
    del jn.append_batch, jn.sync
    launches = dict(rw_kernel.LAUNCHES)
    plain = {**rw_kernel.PLAIN_CALLS, **copy_kernel.PLAIN_CALLS}
    if any(plain.values()):
        raise AssertionError(f"plain versions ran on the card: {plain}")
    per_pump = {k: syncs[k] / pumps[k] for k in syncs}
    if per_pump["on"] != per_pump["off"]:
        raise AssertionError(f"the journal changed the host syncs a pump: "
                             f"{per_pump}")
    t_on, t_off = min(secs["on"]), min(secs["off"])
    overhead = t_on / t_off - 1.0
    js = on.stats()["journal"]
    mount, fstype = fs_of(tmp)
    emit(phase="journal", writes=DUR_WRITES, flush_every=DUR_FLUSH_EVERY,
         ops_per_s={"journal_on": DUR_WRITES / t_on,
                    "journal_off": DUR_WRITES / t_off},
         seconds={k: v for k, v in secs.items()},
         overhead=overhead, gate_floor=DUR_GATE_FLOOR,
         gate_met=DUR_WRITES / t_on >= DUR_GATE_FLOOR * DUR_WRITES / t_off,
         appends=js["appends"], records=js["records"], seq=js["seq"],
         append_ms_per_commit=1e3 * spent["append"] / spent["appends"],
         fsync_ms_per_stream=1e3 * spent["sync"] / 3,
         journal_bytes=os.path.getsize(jp),
         host_syncs_per_pump=per_pump,
         sync_window=dict(pumps=pumps, syncs=syncs),
         journal_dir=tmp, mount=mount, fs_type=fstype,
         launches=launches, card=smi)
    off.close()
    del off
    return dict(mgr=on, path=jp, vid=vids["on"], written=written["on"],
                launches=launches)


def phase_recovery(torch, args, dev, smi, tmp, crashed):
    """8m: recover the abandoned journaled manager of 8l (``crashed``:
    its ``mgr`` is taken out, so nothing else holds it) by full replay,
    then a stream with a SnapshotExport at its middle recovered by install
    plus tail replay, then a journaled stream on the ring recovered by full
    replay. Each recovered volume must equal the crashed one's digest and
    read every written block back."""
    import numpy as np
    from repro_torch.core.blockdev import VolumeManager
    from repro_torch.durability import SnapshotExport, recover
    from repro_torch.kernels.dbs import copy_kernel, rw_kernel
    cfg = durability_config(args)
    out, launches = {}, {}

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    def crash_and_recover(label, box, path, vid, written, **kw):
        mgr = box.pop("mgr")
        want = mgr_digest(torch, mgr, vid)
        del mgr                                   # abandoned, never closed
        free()
        tear_tail(path)
        blocks = replayed_blocks(path)
        for mod in (rw_kernel, copy_kernel):
            mod.reset_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        rec = recover(path, device=dev, **kw)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        got = mgr_digest(torch, rec, vid)
        if got != want:
            raise AssertionError(f"{label}: the recovered volume's digest "
                                 f"{got} != the crashed one's {want}")
        checked = check_blocks(rec, vid, written)
        launches[label] = dict(rw_kernel.LAUNCHES)
        plain = {**rw_kernel.PLAIN_CALLS, **copy_kernel.PLAIN_CALLS}
        if any(plain.values()):
            raise AssertionError(f"plain versions ran on the card: {plain}")
        info = rec.recovery_info
        if not info["torn_tail"]:
            raise AssertionError(f"{label}: the torn tail went unseen")
        out[label] = dict(
            seconds=secs, records_replayed=info["replayed"],
            sealed_records=info["sealed_records"],
            blocks_replayed=blocks, replay_blocks_per_s=blocks / secs,
            after_seq=info["after_seq"], torn_tail=info["torn_tail"],
            dropped_records=info["dropped_records"], digest=got,
            blocks_checked=checked, launches=launches[label])
        return rec, info

    rec, _info = crash_and_recover("fused_full_replay", crashed,
                                   crashed["path"], crashed["vid"],
                                   crashed["written"], **cfg)
    rec.close()
    del rec
    free()

    # a stream with an export at its middle: install plus tail replay
    rng = np.random.default_rng(SEED + 22)
    payloads = [rng.integers(0, 256, BLOCK, dtype=np.uint8).tobytes()
                for _ in range(DUR_FLUSH_EVERY)]
    jp2, xp = os.path.join(tmp, "wal2.dbsj"), os.path.join(tmp, "inc.dbsx")
    mgr = VolumeManager(journal=jp2, device=dev, **cfg)
    vid2 = mgr.create().vid
    exp = SnapshotExport(xp)
    exported = {}

    def export_now():
        tbl = mgr.engine.backend.replicas[0].state.table
        exported["delta"] = int(torch.unique(tbl[tbl >= 0]).numel())
        torch.cuda.synchronize()
        t = time.perf_counter()
        exported.update(exp.export(mgr, journal=mgr._journal))
        exported["seconds"] = time.perf_counter() - t
    written2 = {}
    write_stream(mgr, vid2, payloads, DUR_WRITES, 0, written2,
                 on_half=export_now)
    if exported["extents_moved"] != exported["delta"]:
        raise AssertionError(f"the export moved {exported['extents_moved']} "
                             f"extents, the delta is {exported['delta']}")
    installed = {}
    real_install = SnapshotExport.install

    def timed_install(self, m):
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = real_install(self, m)
        torch.cuda.synchronize()
        installed.update(res, seconds=time.perf_counter() - t)
        return res
    SnapshotExport.install = timed_install
    box = {"mgr": mgr}
    del mgr
    try:
        rec, info = crash_and_recover("fused_export", box, jp2, vid2,
                                      written2, export=xp, **cfg)
    finally:
        SnapshotExport.install = real_install
    if not info["installed"] or info["after_seq"] <= 0:
        raise AssertionError(f"the export was not installed: {info}")
    out["fused_export"].update(
        extents_moved=exported["extents_moved"], delta=exported["delta"],
        export_seconds=exported["seconds"],
        export_bytes_copied=exported["bytes_copied"],
        install_seconds=installed["seconds"],
        install_bytes_copied=installed["bytes_copied"],
        extents_installed=installed["extents_replayed"],
        export_file_bytes=os.path.getsize(xp))
    rec.close()
    del rec, exp
    free()

    # the default backend, the ring, by full replay
    jp3 = os.path.join(tmp, "wal3.dbsj")
    ring_cfg = durability_config(args, backend="ring")
    mgr = VolumeManager(journal=jp3, device=dev, **ring_cfg)
    vid3 = mgr.create().vid
    written3 = {}
    t = write_stream(mgr, vid3, payloads, RING_DUR_WRITES, 0, written3)
    box = {"mgr": mgr}
    del mgr
    rec, _info = crash_and_recover("ring_full_replay", box, jp3, vid3,
                                   written3, **ring_cfg)
    out["ring_full_replay"].update(stream_writes=RING_DUR_WRITES,
                                   stream_ops_per_s=RING_DUR_WRITES / t)
    rec.close()
    del rec
    free()
    emit(phase="recovery", **out, card=smi)
    return launches


def phase_tier(torch, args, dev, smi, untiered_syncs):
    """8n: TIER_PAGES pages written, read back twice on the all-resident
    pool and on a tiered pool cut to TIER_BUDGET device extents (2x
    over-subscribed), every read checked."""
    import numpy as np
    from repro_torch.core import backends
    from repro_torch.core.blockdev import VolumeManager
    from repro_torch.kernels.dbs import copy_kernel, rw_kernel
    rng = np.random.default_rng(SEED + 23)
    page_bytes = BLOCK * PAGE_BLOCKS
    pages = sorted(int(p) for p in rng.choice(args.max_pages, TIER_PAGES,
                                              replace=False))
    data = [rng.integers(0, 256, page_bytes, dtype=np.uint8).tobytes()
            for _ in pages]

    def fill(mgr, vid):
        for p, d in zip(pages, data):
            mgr.pwrite(vid, p * page_bytes, d)
        mgr.flush()

    def read_pass(mgr, vid):
        torch.cuda.synchronize()
        t = time.perf_counter()
        futs = [mgr.pread(vid, p * page_bytes, page_bytes) for p in pages]
        mgr.flush()
        secs = time.perf_counter() - t
        bad = sum(f.result() != d for f, d in zip(futs, data))
        if bad:
            raise AssertionError(f"{bad} of {len(pages)} pages read back "
                                 "wrong")
        return secs

    nbytes = TIER_PAGES * page_bytes
    cfg = durability_config(args)
    mgr = VolumeManager(device=dev, **cfg)
    vid = mgr.create().vid
    fill(mgr, vid)
    resident = min(read_pass(mgr, vid) for _ in range(2))
    mgr.close()
    del mgr
    gc.collect()
    torch.cuda.empty_cache()

    steps = {"write": 0, "read_only": 0}
    inner = (backends.fused_step_tiered, backends.fused_step_read_tiered)

    def write_step(*a, **k):
        steps["write"] += 1
        return inner[0](*a, **k)

    def read_step(*a, **k):
        steps["read_only"] += 1
        return inner[1](*a, **k)
    backends.fused_step_tiered, backends.fused_step_read_tiered = (
        write_step, read_step)
    for mod in (rw_kernel, copy_kernel):
        mod.reset_counts()
    try:
        mgr = VolumeManager(device=dev, tier=args.n_extents, **cfg)
        tier = mgr.engine.impl.tier
        vid = mgr.create().vid
        fill(mgr, vid)
        tier.device_extents = TIER_BUDGET       # the cut: 2x over
        tiered = read_pass(mgr, vid)
        pc = PumpCounter(mgr)
        syncs = count_syncs(torch, lambda: read_pass(mgr, vid))
        sync_pumps = pc.n
        pc.restore()
    finally:
        backends.fused_step_tiered, backends.fused_step_read_tiered = inner
    launches = dict(rw_kernel.LAUNCHES)
    plain = {**rw_kernel.PLAIN_CALLS, **copy_kernel.PLAIN_CALLS}
    if any(plain.values()):
        raise AssertionError(f"plain versions ran on the card: {plain}")
    n_steps = steps["write"] + steps["read_only"]
    per_replica = {"dbs_rw_write": launches["dbs_rw_write"]
                   / max(steps["write"], 1) / REPLICAS,
                   "dbs_rw_read": launches["dbs_rw_read"] / n_steps}
    if per_replica != {"dbs_rw_write": 1.0, "dbs_rw_read": 1.0}:
        raise AssertionError(f"tiered launches a pump per replica: "
                             f"{per_replica}")
    st = mgr.stats()["tier"]
    if st["spills"] <= 0 or st["fills"] <= 0:
        raise AssertionError(f"the tier did not both spill and fill: {st}")
    emit(phase="tier", pages=TIER_PAGES, budget=TIER_BUDGET,
         mapped_extents=TIER_PAGES,
         mib_per_s={"tiered": nbytes / tiered / 2 ** 20,
                    "resident": nbytes / resident / 2 ** 20},
         tier_read_ratio=resident / tiered,
         host_syncs_per_pump={"tiered": syncs / sync_pumps,
                              "untiered_main_path": untiered_syncs},
         sync_window=dict(pumps=sync_pumps, syncs=syncs),
         steps=steps, launches=launches,
         launches_per_pump_per_replica=per_replica, tier=st,
         reads_checked=3 * TIER_PAGES, card=smi)
    mgr.close()
    del mgr
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def harness_line(res, launches, peak, verify_s):
    """What one harness run prints: its ``trace``-document entry (tick
    tails, wait tails, counters) plus launches, peak memory and the
    replay's own rate (the end-of-trace sweeps taken out)."""
    doc = res.to_dict()
    doc.update(events_applied=len(res.events_applied),
               events_skipped=len(res.events_skipped),
               skipped=res.events_skipped, launches=launches,
               max_memory_allocated=peak, verify_s=verify_s,
               replay_ops_per_s=res.n_ops / (res.wall_s - verify_s))
    return doc


def phase_harness(torch, args, dev, smi):
    """8o: the chaos harness (``repro_torch.harness``). (a) every catalog
    scenario at the catalog's geometry and HARNESS_AB_OPS ops on the card
    and on the CPU: equal digests and completion ticks. (b) every scenario
    at the block device's widths at its own op count on the hand-written
    kernels, oracle-clean, plus the determinism replay, gated by
    ``check_trace_gates``; then the HARNESS_EXTRA runs.
    Every card run: DBS launches counted from zero, the plain versions
    never, peak memory. Returns the card's launches over (a) and (b)."""
    from repro_torch.harness import (SCENARIOS, ChaosConfig,
                                     check_trace_gates, run, run_scenario)
    from repro_torch.harness import runner
    from repro_torch.kernels.dbs import copy_kernel, rw_kernel
    total = {"dbs_rw_write": 0, "dbs_rw_read": 0, "dbs_copy": 0}
    verify_s = []
    inner_verify = runner._Run.verify

    def timed_verify(self):
        t = time.perf_counter()
        try:
            return inner_verify(self)
        finally:
            verify_s.append(time.perf_counter() - t)

    def card_run(label, fn, need=()):
        for mod in (rw_kernel, copy_kernel):
            mod.reset_counts()
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        del verify_s[:]
        runner._Run.verify = timed_verify
        try:
            res = fn()
        finally:
            runner._Run.verify = inner_verify
        torch.cuda.synchronize()
        launches = {**rw_kernel.LAUNCHES, **copy_kernel.LAUNCHES}
        plain = {**rw_kernel.PLAIN_CALLS, **copy_kernel.PLAIN_CALLS}
        if any(plain.values()):
            raise AssertionError(f"{label}: plain versions ran on the card: "
                                 f"{plain}")
        missing = [k for k in need if launches[k] <= 0]
        if missing:
            raise AssertionError(f"{label}: {missing} never launched: "
                                 f"{launches}")
        res.raise_if_failed()
        for k in total:
            total[k] += launches[k]
        peak = torch.cuda.max_memory_allocated(dev)
        return res, launches, peak, sum(verify_s)

    # (a) the card against the CPU at the catalog's geometry
    def needs(kw):
        # the hand-written kernels serve the fused, sharded and ring steps
        # (the copy entry: dbs_copy for the CoW rows, torch for the rest);
        # slots replicas write and read with plain indexing, as the
        # reference's do
        if kw["backend"] not in ("fused", "sharded", "ring"):
            return ()
        if kw.get("kernel") == "copy":
            return ("dbs_copy",)
        return ("dbs_rw_write", "dbs_rw_read")

    same = {}
    t0 = time.perf_counter()
    for name in SCENARIOS:
        cpu = run_scenario(name, n_ops=HARNESS_AB_OPS, device="cpu")
        cpu.raise_if_failed()
        gpu, launches, _peak, _v = card_run(
            f"{name} (catalog geometry)",
            lambda: run_scenario(name, n_ops=HARNESS_AB_OPS, device=dev),
            needs(SCENARIOS[name]))
        ticks_equal = gpu.completion_ticks == cpu.completion_ticks
        if gpu.digest != cpu.digest or not ticks_equal:
            raise AssertionError(f"harness {name}: the card's digest "
                                 f"{gpu.digest} != the CPU's {cpu.digest} "
                                 f"(ticks equal: {ticks_equal})")
        same[name] = dict(digest=gpu.digest, checked_reads=gpu.checked_reads,
                          launches=launches)
    emit(phase="harness_card_vs_cpu", ops=HARNESS_AB_OPS, scenarios=same,
         seconds=time.perf_counter() - t0, card=smi)

    # (b) the catalog at the block device's widths (4 KiB blocks, an fp32
    # lane a byte; 32-block pages; 64-lane pumps; the main path's extent
    # pool; the volume cut to HARNESS_PAGES pages), gated as run_matrix's
    geo = dict(block_bytes=BLOCK, page_blocks=PAGE_BLOCKS,
               n_pages=HARNESS_PAGES, batch=BATCH, n_extents=args.n_extents,
               max_volumes=12, n_queues=4, n_slots=256)
    trace, runs = {}, {}
    t0 = time.perf_counter()
    for name in SCENARIOS:
        res, launches, peak, vs = card_run(name, lambda: run_scenario(
            name, geometry=geo, kernel="auto", device=dev),
            needs(SCENARIOS[name]))
        trace[name] = res.to_dict()
        runs[name] = harness_line(res, launches, peak, vs)
        emit(phase="harness_run", scenario=name, geometry=geo, **runs[name],
             card=smi)
        if name == runner.DETERMINISM_SCENARIO:
            first = res
        del res
    again, _l, _p, _v = card_run("determinism", lambda: run_scenario(
        runner.DETERMINISM_SCENARIO, geometry=geo, kernel="auto",
        device=dev))
    trace["determinism"] = {
        "scenario": runner.DETERMINISM_SCENARIO,
        "digest_a": first.digest, "digest_b": again.digest,
        "ticks_match": first.completion_ticks == again.completion_ticks,
        "match": (first.digest == again.digest
                  and first.completion_ticks == again.completion_ticks)}
    del first, again
    problems = check_trace_gates(trace)
    if problems:
        raise AssertionError(f"harness gates: {problems}")
    if not (total["dbs_rw_write"] and total["dbs_rw_read"]):
        raise AssertionError(f"the catalog launched no DBS kernel: {total}")
    extra = {}
    for label, kw in HARNESS_EXTRA:
        res, launches, peak, vs = card_run(label, lambda: run(
            trace=SCENARIOS["chaos/simnet"]["trace"],
            chaos=ChaosConfig(n_events=10, weights=HARNESS_LINKS_OFF),
            n_replicas=REPLICAS, geometry=geo, device=dev, **kw), needs(kw))
        extra[label] = harness_line(res, launches, peak, vs)
        emit(phase="harness_run", scenario=label, geometry=geo,
             **extra[label], card=smi)
        del res
    emit(phase="harness", geometry=geo, cut=dict(
             n_pages=HARNESS_PAGES, main_path_pages=args.max_pages,
             card_vs_cpu_ops=HARNESS_AB_OPS),
         gates=problems, determinism=trace["determinism"],
         ops_per_s={k: v["ops_per_s"] for k, v in {**runs, **extra}.items()},
         tick_p99={k: v["latency"]["all"]["p99"]
                   for k, v in {**runs, **extra}.items()},
         straggler_wait={k: {q: runs[k]["wait"]["read"][q]
                             for q in ("p99", "p999")}
                         for k in ("straggler/rr", "straggler/latency")},
         seconds=time.perf_counter() - t0, launches=total, card=smi)
    return total


def phase_no_sync(torch, mgr):
    from repro_torch.core import backends
    inner = backends.fused_step
    calls = []

    def guarded(*a, **k):
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = inner(*a, **k)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        calls.append(1)
        return out

    backends.fused_step = guarded
    try:
        vol = mgr.open(0)
        futs = [vol.pwrite(i * 7 * BLOCK, bytes([i]) * BLOCK)
                for i in range(BATCH)]
        mgr.pump()
    finally:
        backends.fused_step = inner
    if not calls or not all(f.done() for f in futs):
        raise AssertionError("the guarded write pump did not run")
    emit(phase="no_sync", guarded_steps=len(calls), lanes=BATCH)


# ---------------------------------------------------------------------------
# phase 9: zero-copy serving at gemma2-2b's full width
# ---------------------------------------------------------------------------
def _serve_engine(torch, cfg, params, dev, record_logits=False,
                  kv_backend="fused", max_len=2048, plan=None, kernel="cuda",
                  **kw):
    from repro_torch.configs.base import ExecutionPlan
    from repro_torch.serving.engine import ServeEngine
    plan = plan or ExecutionPlan(attn_impl="cuda", compute_dtype="float32")
    return ServeEngine(cfg, params, n_slots=8, max_len=max_len, n_queues=2,
                       kv_backend=kv_backend, kv_replicas=2, kernel=kernel,
                       plan=plan, record_logits=record_logits, device=dev,
                       **kw)


def _serve_traffic(torch, eng, prompts, keep_flash, keep_layers=None):
    """Run ``prompts`` (request ids 0.., SERVE_NEW new tokens each) on a
    zero-copy engine under phase 9's instrumentation, check the run, and
    hold what it kept against the plain versions (phase 10).

    Timed: each request's prefill, the write pumps, the decode program.
    Counted: fused steps (pumps) and decode steps. Kept: every decode
    step's top-2 margins; the paged calls of the SERVE_KEEP_STEPS decode
    steps (the first ``keep_layers`` of each, or all); the flash calls
    ``keep_flash(kept, q, kw)`` accepts; and the DBS kernels' inputs of
    every READ_SERVE_EVERY-th pump (the read's, and replica 0's write).
    Checked: every request ends with SERVE_NEW tokens; after a flush the
    replicas' metadata and pool contents (bar the dump row) agree; no
    volume or extent is left; every kernel of the path launched,
    ``paged_attention`` once a paged layer a decode step and
    ``flash_attention`` once a layer a prompt; no plain version ran. The
    kept calls are then held against the plain versions on the traffic's
    own pool, before anything else runs on the engine."""
    from repro_torch.core import backends, dbs
    from repro_torch.kernels.dbs import ops as dbs_ops
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention import ops as f_ops
    from repro_torch.kernels.paged_attention import kernel as pk
    from repro_torch.serving import engine as serving
    from repro_torch.serving.engine import GenRequest
    cfg = eng.cfg
    clock = {"prefill": 0.0, "pumps": 0.0, "decode": 0.0}
    counts = {"fused_steps": 0, "decode_steps": 0, "paged_this_step": 0}
    kept = {"paged": [], "flash": [], "read": [], "write": []}
    prefill_s, margins, write_pump = {}, [], [0]
    inner = {"prefill": eng._prefill_one_zero, "pump": eng._pump_writes,
             "step": eng._step_fn, "fused": backends.fused_step,
             "paged": serving.paged_attention_pool_fwd,
             "flash": f_ops.flash_attention_fwd, "read": dbs_ops.dbs_rw_read,
             "write": dbs_ops.dbs_rw_write}

    def timed(name, fn):
        def run(*a, **k):
            t = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            clock[name] += time.perf_counter() - t
            return out
        return run

    def prefill(g):
        t = time.perf_counter()
        inner["prefill"](g)
        torch.cuda.synchronize()
        prefill_s[g.req_id] = time.perf_counter() - t
        clock["prefill"] += prefill_s[g.req_id]

    def step_fn(*a, **k):
        counts["decode_steps"] += 1
        counts["paged_this_step"] = 0
        return inner["step"](*a, **k)

    def fused(*a, **k):
        counts["fused_steps"] += 1
        return inner["fused"](*a, **k)

    def paged(q, pool, table, lengths, **k):
        if counts["decode_steps"] in SERVE_KEEP_STEPS and (
                keep_layers is None
                or counts["paged_this_step"] < keep_layers):
            kept["paged"].append((q.clone(), table.clone(), lengths.clone(),
                                  dict(k)))
        counts["paged_this_step"] += 1
        return inner["paged"](q, pool, table, lengths, **k)

    def flash(q, k, v, **kw):
        if keep_flash(kept["flash"], q, kw):
            kept["flash"].append((q.clone(), k.clone(), v.clone(), dict(kw)))
        return inner["flash"](q, k, v, **kw)

    def read(pool, ext, block):
        if counts["fused_steps"] % READ_SERVE_EVERY == 1:
            kept["read"].append((ext.clone(), block.clone()))
        return inner["read"](pool, ext, block)

    def write(pool, src, dst, lane_of, payload, **k):
        n = counts["fused_steps"]
        if n % READ_SERVE_EVERY == 1 and write_pump[0] != n:
            write_pump[0] = n                    # the pump's first replica
            kept["write"].append(tuple(t.clone() for t in (
                src, dst, lane_of, payload)))
        return inner["write"](pool, src, dst, lane_of, payload, **k)

    eng._prefill_one_zero = prefill
    eng._pump_writes = timed("pumps", inner["pump"])
    eng._step_fn = timed("decode", _margin_step(torch, eng, step_fn, margins))
    backends.fused_step = fused
    serving.paged_attention_pool_fwd = paged
    f_ops.flash_attention_fwd = flash
    dbs_ops.dbs_rw_read, dbs_ops.dbs_rw_write = read, write
    mods = _kernel_modules()
    for mod in mods:
        mod.reset_counts()
    try:
        t0 = time.perf_counter()
        for rid, pr in enumerate(prompts):
            eng.submit(GenRequest(req_id=rid, prompt=pr, max_new=SERVE_NEW))
        outs = eng.run(max_steps=10 * SERVE_NEW * len(prompts))
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = {k: v for mod in mods for k, v in mod.LAUNCHES.items()}
        by_dtype = {"paged_attention": dict(pk.LAUNCHES_BY_DTYPE),
                    "flash_attention": dict(fk.LAUNCHES_BY_DTYPE)}
        by_form = {"paged_attention": dict(pk.LAUNCHES_BY_INSTANCE),
                   "flash_attention": dict(fk.LAUNCHES_BY_FORM)}
        plain = {k: v for mod in mods for k, v in mod.PLAIN_CALLS.items()}
    finally:
        backends.fused_step = inner["fused"]
        serving.paged_attention_pool_fwd = inner["paged"]
        f_ops.flash_attention_fwd = inner["flash"]
        dbs_ops.dbs_rw_read = inner["read"]
        dbs_ops.dbs_rw_write = inner["write"]
        eng._prefill_one_zero = inner["prefill"]
        eng._pump_writes = inner["pump"]
        eng._step_fn = inner["step"]
    peak = torch.cuda.max_memory_allocated(eng.device)
    bad = [rid for rid in range(len(prompts))
           if len(outs.get(rid, [])) != SERVE_NEW]
    if bad:
        raise AssertionError(f"{cfg.name}: requests {bad} did not end with "
                             f"{SERVE_NEW} tokens")
    eng.volumes.flush()
    if not eng.volumes.engine.backend.consistent():
        raise AssertionError(f"{cfg.name}: the KV replicas disagree after "
                             f"a flush")
    # the decode program scatters into every replica's pool in place: their
    # contents must agree too, bar the dump row (inactive lanes scatter
    # there in no fixed order, and nothing reads it)
    pools = eng.volumes.device_pools()
    if not all(torch.equal(pools[0][:-1], p[:-1]) for p in pools[1:]):
        raise AssertionError(f"{cfg.name}: the KV replica pools' contents "
                             f"differ")
    del pools
    st = dbs.stats(eng.state)
    if st["volumes"] or st["extents_used"]:
        raise AssertionError(f"{cfg.name}: volumes or extents leaked: {st}")
    if min(launches[k] for k in ("dbs_rw_write", "dbs_rw_read",
                                 "paged_attention", "flash_attention")) <= 0:
        raise AssertionError(f"{cfg.name}: a kernel of the serve path never "
                             f"launched: {launches}")
    if any(plain.values()):
        raise AssertionError(f"{cfg.name}: plain versions ran on the card: "
                             f"{plain}")
    n_paged = len(eng._paged)
    if launches["paged_attention"] != n_paged * counts["decode_steps"] or \
            launches["flash_attention"] != cfg.n_layers * len(prompts):
        raise AssertionError(f"{cfg.name}: launches {launches}, not "
                             f"{n_paged} paged a decode step and "
                             f"{cfg.n_layers} flash a prompt")
    parity = {"paged_attention": phase_paged_kernel(torch, eng, kept),
              "flash_attention": phase_flash_kernel(torch, kept),
              "dbs_rw_read": phase_read_kernel_serve(torch, eng,
                                                     kept["read"]),
              "dbs_rw_write": phase_write_kernel_serve(torch, eng,
                                                       kept["write"])}
    return {"outs": outs, "run_s": run_s, "clock": clock, "counts": counts,
            "prefill_s": prefill_s, "margin_of": _margin_map(torch, margins),
            "launches": launches, "launches_by_dtype": by_dtype,
            "launches_by_form": by_form,
            "plain": plain, "dbs_stats": st, "peak": peak, "parity": parity,
            "kept_paged": kept["paged"], "kept_read": kept["read"],
            "kept_write": kept["write"]}


def _flash_form_is(model, res, want):
    """Every flash launch of a serve run (``_serve_traffic``'s result) of
    the form ``want``, as its kept calls' parity entry reports too."""
    n = res["launches"]["flash_attention"]
    by_form = res["launches_by_form"]["flash_attention"]
    form = res["parity"]["flash_attention"]["form"]
    if by_form[want] != n or form != want:
        raise AssertionError(f"{model}: flash launches {by_form} of {n}, "
                             f"kept calls of {form}: not {want} alone")


def _serve_fields(lens, res):
    """The serve_path line's fields every zero-copy serving phase prints."""
    gen = len(lens) * SERVE_NEW
    clock, counts = res["clock"], res["counts"]
    return dict(
        requests=len(lens), prompt_tokens=int(lens.sum()),
        prompt_lengths=[int(x) for x in lens], generated_tokens=gen,
        run_seconds=res["run_s"], prefill_seconds=clock["prefill"],
        pump_seconds=clock["pumps"], decode_seconds=clock["decode"],
        decode_steps=counts["decode_steps"],
        decode_tokens_per_s=gen / clock["decode"],
        tokens_per_s=gen / res["run_s"], pumps=counts["fused_steps"],
        launches=res["launches"], plain_calls=res["plain"],
        dbs_stats=res["dbs_stats"], max_memory_allocated=res["peak"])


def _serve_config(cfg, eng, **extra):
    return dict(kv_backend="fused", kv_replicas=2, n_slots=8,
                max_len=eng.max_len,
                n_queues=2, kernel="cuda", attn_impl="cuda",
                dtype=eng.plan.compute_dtype,
                page_blocks=cfg.page_blocks, paged_layers=len(eng._paged),
                payload_shape=list(eng._payload_shape), **extra)


def _keep_local_global(kept, q, kw) -> bool:
    """gemma2's flash calls kept: the first prompt's first local and first
    global layer."""
    return len(kept) < 2 and (not kept
                              or kw["window"] != kept[0][3]["window"])


def _serve_prompts(np, cfg):
    """Phase 9's SERVE_REQUESTS prompts (seeded lengths in SERVE_PROMPT):
    (lengths, prompts); phase 29 serves the same."""
    rng = np.random.default_rng(SEED + 2)
    lens = rng.integers(SERVE_PROMPT[0], SERVE_PROMPT[1] + 1, SERVE_REQUESTS)
    return lens, [rng.integers(0, cfg.vocab_size, n) for n in lens]


def phase_serve(torch, dev, smi):
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.kernels.dbs import rw_kernel
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.paged_attention import kernel as pk
    from repro_torch.models import init_params
    cfg = get_config(SERVE_MODEL)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held_before = torch.cuda.memory_allocated(dev)
    t0 = time.perf_counter()
    params = init_params(torch.Generator(device=dev).manual_seed(SEED), cfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    eng = _serve_engine(torch, cfg, params, dev)
    lens, prompts = _serve_prompts(np, cfg)
    res = _serve_traffic(torch, eng, prompts, _keep_local_global)
    _flash_form_is(SERVE_MODEL, res, "f32_wgmma")
    # fork check: a session forked after its 4th decode step against a
    # second engine decoding the same two streams independently
    for mod in (rw_kernel, pk, fk):
        mod.reset_counts()
    fork = phase_fork_check(torch, cfg, params, dev, eng, prompts[0])
    emit(phase="serve_path", model=SERVE_MODEL,
         config=_serve_config(cfg, eng), **_serve_fields(lens, res),
         init_seconds=init_s, fork=fork,
         fork_check_launches={**rw_kernel.LAUNCHES, **pk.LAUNCHES,
                              **fk.LAUNCHES},
         memory_allocated_before=held_before, card=smi)
    return eng, res, (cfg, params, prompts)


def phase_fork_check(torch, cfg, params, dev, eng, prompt):
    """Fork a session after its 4th decode step (both sides diverge by CoW
    of the shared frontier page); a second engine of the same backend
    decodes the same two streams independently. Tokens must be equal;
    returns the largest logit difference (parent, child) for the record."""
    import numpy as np
    from repro_torch.serving.engine import GenRequest
    eng.record_logits = True
    base = 1000
    eng.submit(GenRequest(req_id=base, prompt=prompt.copy(),
                          max_new=SERVE_NEW))
    for _ in range(4):
        eng.step()
    child = eng.fork(base, base + 1, max_new=SERVE_NEW - 4)
    if child is None:
        raise AssertionError("fork found no free slot or volume")
    eng.run(max_steps=4 * SERVE_NEW)
    eng.record_logits = False
    ref = _serve_engine(torch, cfg, params, dev, record_logits=True,
                        kv_backend=eng.kv_backend, max_len=eng.max_len)
    for rid in (0, 1):
        ref.submit(GenRequest(req_id=rid, prompt=prompt.copy(),
                              max_new=SERVE_NEW))
    ref.run(max_steps=4 * SERVE_NEW)
    par, chi = eng.live[base], eng.live[base + 1]
    if par.out_tokens != ref.live[0].out_tokens:
        raise AssertionError("the forked parent's tokens differ from an "
                             "independent decode")
    if chi.out_tokens != ref.live[1].out_tokens[:len(chi.out_tokens)]:
        raise AssertionError("the fork's tokens differ from an independent "
                             "decode")
    n_c = len(chi.logit_trace)
    d_par = float(np.abs(np.stack(par.logit_trace[4:])
                         - np.stack(ref.live[0].logit_trace[4:])).max())
    d_chi = float(np.abs(np.stack(chi.logit_trace)
                         - np.stack(ref.live[1].logit_trace[4:4 + n_c])).max())
    ref.volumes.close()
    del ref
    gc.collect()             # the manager's reference cycles hold its pools
    torch.cuda.empty_cache()
    return {"tokens_equal": True, "parent_tokens": len(par.out_tokens),
            "child_tokens": len(chi.out_tokens),
            "max_logit_diff_parent": d_par, "max_logit_diff_child": d_chi}


# ---------------------------------------------------------------------------
# phase 10: the attention kernels on the serve path's kept inputs
# ---------------------------------------------------------------------------
def phase_paged_kernel(torch, eng, kept):
    import torch.nn.functional as F
    from repro_torch.kernels.paged_attention import (paged_attention_pool_fwd,
                                                     paged_attention_pool_ref)
    from repro_torch.kernels.paged_attention.kernel import (
        paged_block_rows, paged_form, paged_info, paged_splits, paged_work,
        sm_count)
    from repro_torch.kernels.timing import graph_ms
    calls = kept["paged"]
    if not calls:
        raise AssertionError("no paged-attention inputs were kept")
    pool = eng._pools[0]
    _e, page, _np_, kv, d = pool.shape
    dtype = calls[0][0].dtype
    tol = _attn_tol(torch, dtype)
    err, n_bytes, flops = 0.0, [], []
    for q, table, lengths, kw in calls:
        got = paged_attention_pool_fwd(q, pool, table, lengths, **kw)
        want = paged_attention_pool_ref(q, pool, table, lengths,
                                        **kw).to(dtype)
        torch.testing.assert_close(got.float(), want.float(), **tol)
        err = max(err, float((got.float() - want.float()).abs().max()))
        # the live pages' K and V planes, q, the table and the output
        f, nb = paged_work(q, table, lengths, page, kv, d, d, kw["window"],
                           pool.element_size())
        flops.append(f)
        n_bytes.append(nb)
    n = len(calls)
    ms = graph_ms(lambda: [paged_attention_pool_fwd(q, pool, t, ln, **k)
                                  for q, t, ln, k in calls], n)
    plain = graph_ms(lambda: [
        paged_attention_pool_ref(q, pool, t, ln, **k).to(dtype)
        for q, t, ln, k in calls], n)
    # yardstick: index_select gathers of the K and V planes, then SDPA with
    # a boolean mask (holes, lengths; no logit cap, which SDPA cannot
    # apply), a KV head's G query heads on SDPA's query axis (GQA's
    # expansion would copy K and V G times: 4.5 GiB at MLA's G = 128)
    lib_in = []
    for q, table, lengths, kw in calls:
        b, h, _ = q.shape
        p_max = table.shape[1]
        pos = torch.arange(p_max * page, device=q.device)
        valid = (pos[None, :] < lengths[:, None]) & (
            table >= 0).repeat_interleave(page, dim=1)
        idx = table.clamp(min=0).reshape(-1).long()
        lib_in.append((q.reshape(b, kv, h // kv, d), idx,
                       valid[:, None, None, :], b, p_max, kw["k_plane"],
                       kw["v_plane"]))

    def library():
        for q4, idx, mask, b, p_max, kp, vp in lib_in:
            kk = pool[:, :, kp].index_select(0, idx).reshape(
                b, p_max * page, kv, d).transpose(1, 2)
            vv = pool[:, :, vp].index_select(0, idx).reshape(
                b, p_max * page, kv, d).transpose(1, 2)
            F.scaled_dot_product_attention(q4, kk.to(dtype), vv.to(dtype),
                                           attn_mask=mask)
    lib = graph_ms(library, n)
    mean_b, mean_f = sum(n_bytes) / n, sum(flops) / n
    # the grid the wrapper picks: b * paged_block_rows x n_split main
    # blocks, then the merge kernel
    b, h, _ = calls[0][0].shape
    p_max = calls[0][1].shape[1]
    rows = b * paged_block_rows(h, kv, d, d)
    n_split = paged_splits(p_max, rows, sm_count(pool.device), h // kv, d)
    info = paged_info(h // kv, d, d, True, True, p_max, n_split, dtype=dtype,
                      kv_dtype=pool.dtype)
    # the packed instantiation's products on the tensor cores
    # (_packed_rate); the lanes kernel's at the fp32 rate of the CUDA cores
    instance = paged_form(h // kv, d, d)
    rate = (FP32_FLOPS_PER_S if instance == "lanes" else
            _packed_rate(torch, dtype, pool.dtype, d, d))
    emit(phase="kernel_parity", kernel="paged_attention", calls=n,
         pool_shape=list(pool.shape), q_shape=list(calls[0][0].shape),
         table_shape=list(calls[0][1].shape), max_abs_err=err,
         bytes_per_call=mean_b, flops_per_call=mean_f, splits=n_split,
         instance=instance, tolerance=tol, dtype=str(dtype),
         pool_dtype=str(pool.dtype))
    cast = ("" if dtype == pool.dtype
            else ", the gathered K and V cast to q's dtype")
    return {"name": "paged_attention", "route": "cuda", "source": PAGED_SRC,
            "replaces": "src/repro/kernels/paged_attention/kernel.py:96",
            "max_abs_err": err, "ms": ms, "plain_ms": plain,
            "bound_ms": max(mean_b / HBM_BYTES_PER_S, mean_f / rate) * 1e3,
            "bound_by": ("bytes" if mean_b / HBM_BYTES_PER_S
                         >= mean_f / rate else "operations"),
            "library_ms": lib,
            "library_call": "two index_select gathers (K and V planes) + "
                            "scaled_dot_product_attention with a boolean "
                            "mask, a KV head's query heads on its query "
                            "axis, no logit cap" + cast,
            "bytes_per_call": mean_b, "flops_per_call": mean_f,
            "splits": n_split, "instance": instance,
            "kernels_per_call": 2 if n_split > 1 or instance == "packed"
            else 1,
            **resources(torch, info, rows * n_split)}


def _packed_rate(torch, q_dtype, pool_dtype, d, dv):
    """The rate of the packed paged kernel's products on the tensor cores,
    flops a second. Over 16-bit pools (bf16 or fp16), their dense rate
    (the same). Over fp32 pools, 3xTF32's (a third of the TF32 rate: three
    TF32 products a multiply-add), except q.K^T for 16-bit q, which is
    exact in TF32 and so takes two products: the two rates then mixed by
    their products' shares of the flops (d of a position's d + dv
    multiply-adds are q.K^T's)."""
    if pool_dtype != torch.float32:
        return BF16_FLOPS_PER_S
    tf32 = 3 * TF32X3_FLOPS_PER_S            # the dense TF32 rate
    qk = tf32 / (2 if q_dtype != torch.float32 else 3)
    return (d + dv) / (d / qk + dv / TF32X3_FLOPS_PER_S)


def phase_flash_kernel(torch, kept):
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (attention_ref,
                                                     flash_attention_fwd)
    from repro_torch.kernels.flash_attention.kernel import (
        flash_form, flash_info, flash_parts, flash_work)
    from repro_torch.kernels.timing import graph_ms
    calls = kept["flash"]
    if len(calls) < 2:
        raise AssertionError("the local and global prefill inputs were not "
                             "both kept")
    dtype = calls[0][0].dtype
    tol = _attn_tol(torch, dtype)
    # fp32 runs in 3xTF32 (three TF32 products a multiply-add), bf16 and
    # fp16 on the tensor cores at their (one) dense rate
    rate = TF32X3_FLOPS_PER_S if dtype == torch.float32 else \
        BF16_FLOPS_PER_S
    err, flops, n_bytes, bounds = 0.0, [], [], []
    for q, k, v, kw in calls:
        got = flash_attention_fwd(q, k, v, **kw)
        want = attention_ref(q, k, v, **kw).to(dtype)
        torch.testing.assert_close(got.float(), want.float(), **tol)
        err = max(err, float((got.float() - want.float()).abs().max()))
        # QK^T and PV over the visible pairs; q, k, v and the output once
        f, nb = flash_work(q, k, v, kw.get("causal", True), kw["window"])
        flops.append(f)
        n_bytes.append(nb)
        bounds.append(max(f / rate, nb / HBM_BYTES_PER_S))
    n = len(calls)
    ms = graph_ms(lambda: [flash_attention_fwd(q, k, v, **kw)
                                  for q, k, v, kw in calls], n)
    plain = graph_ms(lambda: [attention_ref(q, k, v, **kw).to(dtype)
                                     for q, k, v, kw in calls], n)
    cont = [(q.contiguous(), k.contiguous(), v.contiguous())
            for q, k, v, _ in calls]
    lib = graph_ms(lambda: [F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True) for q, k, v in cont], n)
    f_mean, b_mean = sum(flops) / n, sum(n_bytes) / n
    bound = sum(bounds) / n
    q0, k0, v0 = calls[0][:3]
    form = flash_form(q0.shape[-1], v0.shape[-1], dtype,
                      [x for t in (q0, k0, v0) for x in t.stride()[:3]],
                      [t.data_ptr() for t in (q0, k0, v0)])
    info = flash_info(q0.shape[-1], v0.shape[-1], dtype, form)
    # the fp32 wgmma form shares a tile's keys over flash_parts blocks
    grid = [c[0].shape[0] * c[0].shape[1]
            * -(-c[0].shape[2] // info["rows_per_block"])
            * (flash_parts(*c[0].shape[:3], torch.cuda.get_device_properties(
                0).multi_processor_count) if form == "f32_wgmma" else 1)
            for c in calls]
    emit(phase="kernel_parity", kernel="flash_attention", calls=n,
         q_shapes=[list(c[0].shape) for c in calls],
         v_shapes=[list(c[2].shape) for c in calls],
         windows=[c[3]["window"] for c in calls], max_abs_err=err,
         flops_per_call=f_mean, bytes_per_call=b_mean, tolerance=tol,
         dtype=str(dtype), form=form)
    fp32 = dtype == torch.float32
    return {"name": "flash_attention", "route": "cuda",
            "source": (FLASH_WGMMA_F32_SRC if form == "f32_wgmma"
                       else FLASH_WGMMA_SRC if form.endswith("_wgmma")
                       else FLASH_SRC),
            "form": form,
            "replaces": "src/repro/kernels/flash_attention/kernel.py:77",
            "max_abs_err": err, "ms": ms, "plain_ms": plain,
            "bound_ms": bound * 1e3,
            "bound_by": ("operations" if f_mean / rate
                         >= b_mean / HBM_BYTES_PER_S else "bytes"),
            "bound_rate": ("fp32 flops in 3xTF32 on the tensor cores, "
                           "495/3 = 165 TFLOP/s" if fp32 else
                           f"{_tag16(torch, dtype)} flops on the tensor "
                           f"cores, 989 TFLOP/s dense")
            + "; bytes at 3.35 TB/s",
            "library_ms": lib,
            "library_call": "scaled_dot_product_attention(is_causal=True, "
                            "enable_gqa=True), %s, without the logit cap"
                            % ("fp32" if fp32 else _tag16(torch, dtype)),
            "flops_per_call": f_mean,
            **resources(torch, info, max(grid)),
            "grid_blocks_per_call": grid}


# ---------------------------------------------------------------------------
# phase 11: the decode program never waits on the host
# ---------------------------------------------------------------------------
def phase_no_sync_serve(torch, eng):
    import numpy as np
    from repro_torch.serving.engine import GenRequest
    inner = eng._step_fn
    calls = []

    def guarded(*a, **k):
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = inner(*a, **k)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        calls.append(1)
        return out

    eng._step_fn = guarded
    try:
        rng = np.random.default_rng(SEED + 3)
        eng.submit(GenRequest(req_id=2000, prompt=_prompt(
            rng, eng.cfg, 40), max_new=2))
        eng.run(max_steps=8)
    finally:
        eng._step_fn = inner
    if not calls or not eng.live[2000].done:
        raise AssertionError("the guarded decode program did not run")
    emit(phase="no_sync", path="serve_path", guarded_decode_steps=len(calls))


# ---------------------------------------------------------------------------
# phase 12: where a serving step's time goes
# ---------------------------------------------------------------------------
def _profiled(torch, name: str, fn, smi) -> dict:
    """Run ``fn`` once under ``torch.profiler`` and emit its wall time, the
    device's busy time (the union of the device events' intervals), its
    idle share, the device events counted, and the names that took the
    most device time (kernels) and host time (operators, inclusive of
    what they call); returns the first four. The profiler's raw events
    are read (``kineto_results``): building its operator tree costs ~65
    us an event on the host, a minute for a step of 48k kernels."""
    from collections import defaultdict

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    events = prof.profiler.kineto_results.events()
    spans, device, host = [], defaultdict(lambda: [0, 0]), \
        defaultdict(lambda: [0, 0])
    for e in events:
        on_device = e.device_type() == DeviceType.CUDA
        if on_device:
            spans.append((e.start_ns(), e.end_ns()))
        acc = (device if on_device else host)[e.name()]
        acc[0] += 1
        acc[1] += e.duration_ns()
    spans.sort()
    busy, end = 0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    busy /= 1e9                                  # ns -> s

    def top(table, key, n):
        return [{"op": k[:80], "calls": c, key: ns / 1e6}
                for k, (c, ns) in sorted(table.items(),
                                         key=lambda kv: -kv[1][1])[:n]]
    out = dict(wall_s=wall, device_busy_s=busy,
               device_idle_share=1.0 - busy / wall, device_events=len(spans))
    emit(phase="profile", part=name, **out,
         top_device=top(device, "device_ms", 10),
         top_host=top(host, "host_ms_inclusive", 6), card=smi)
    return out


def phase_profile_serve(torch, eng, smi):
    """Eight requests fill the slots. After two warm-up steps (admission and
    prefill ride the first), time PROFILE_STEPS decode steps, then profile
    PROFILE_STEPS more; the shortest request ends on the last of them. Then
    profile a ninth prompt's prefill into the slot it freed, and the write
    pumps that land that prompt's K/V; the engine then drains."""
    import numpy as np
    from repro_torch.core import dbs
    from repro_torch.serving.engine import GenRequest
    rng = np.random.default_rng(SEED + 4)
    lens = rng.integers(SERVE_PROMPT[0], SERVE_PROMPT[1] + 1, eng.n_slots + 1)
    prompts = [rng.integers(0, eng.cfg.vocab_size, n) for n in lens]
    done_at = 2 + 2 * PROFILE_STEPS
    for i in range(eng.n_slots):
        eng.submit(GenRequest(req_id=3000 + i, prompt=prompts[i],
                              max_new=done_at + (i > 0)))
    for _ in range(2):
        eng.step()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(PROFILE_STEPS):
        eng.step()
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t) / PROFILE_STEPS
    emit(phase="profile", part="decode, unprofiled", slots=eng.n_slots,
         steps=PROFILE_STEPS, decode_step_s=step_s, card=smi)
    _profiled(torch, f"decode x{PROFILE_STEPS}",
              lambda: [eng.step() for _ in range(PROFILE_STEPS)], smi)
    g = GenRequest(req_id=3100, prompt=prompts[-1], max_new=1)
    eng.submit(g)
    admitted = eng._admit()
    if len(admitted) != 1 or admitted[0] is not g:
        raise AssertionError("the profiled prompt found no free slot")
    _profiled(torch, f"prefill ({len(g.prompt)} tokens, model + payload)",
              lambda: eng._prefill_one_zero(g), smi)
    kib = 4 * math.prod(eng._payload_shape) / 1024
    _profiled(torch, f"write pumps ({len(g.prompt)} lanes of {kib:g} KiB)",
              eng._pump_writes, smi)
    eng.run(max_steps=4)
    st = dbs.stats(eng.state)
    if not all(r.done for r in eng.live.values()) or st["volumes"]:
        raise AssertionError(f"the profiled requests did not drain: {st}")


# ---------------------------------------------------------------------------
# phases 13-14: the copy-based serving baseline at the same width
# ---------------------------------------------------------------------------
def _model_pools(eng):
    """The copy-based baseline's model-owned KV pools (K and V of each
    global layer)."""
    return [c[key] for c in eng.caches if c is not None and "pool_k" in c
            for key in ("pool_k", "pool_v")]


def phase_serve_host(torch, dev, smi, cfg, params, prompts):
    """``ServeEngine(kv_backend="host")`` with the zero-copy path's settings
    and its 16 requests: the host backend allocates pages, model-owned
    pools hold the K/V, prefill runs the flash kernel and decode the plain
    paged gather (as the reference's baseline does). Then the fork check
    on this backend, the phase that launches ``dbs_copy`` on the serving
    path (one call per pool, K and V of 13 global layers, per CoW'd
    batch); its copy inputs are kept for the kernel's parity."""
    from repro_torch.core import dbs
    from repro_torch.kernels.dbs import copy_kernel
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.paged_attention import kernel as pk
    from repro_torch.models import model as M
    from repro_torch.serving import engine as serving
    from repro_torch.serving.engine import GenRequest
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    eng = _serve_engine(torch, cfg, params, dev, kv_backend="host")
    clock = {"prefill": 0.0, "alloc": 0.0, "decode": 0.0}
    counts = {"alloc_calls": 0, "decode_steps": 0}
    kept = []
    inner = {"prefill": eng._prefill_one_host, "alloc": eng._alloc_pages,
             "decode": M.decode_step, "copy": serving.dbs_copy_pool}

    def timed(name, fn):
        def run(*a, **k):
            t = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            clock[name] += time.perf_counter() - t
            return out
        return run

    def alloc(*a, **k):
        counts["alloc_calls"] += 1
        return inner["alloc"](*a, **k)

    def decode(*a, **k):
        counts["decode_steps"] += 1
        return inner["decode"](*a, **k)

    def copy(pool, src, dst, mask, **k):
        if len(kept) < len(_model_pools(eng)):     # one CoW'd batch
            kept.append((pool, src.clone(), dst.clone(), mask.clone()))
        return inner["copy"](pool, src, dst, mask, **k)

    eng._prefill_one_host = timed("prefill", inner["prefill"])
    eng._alloc_pages = timed("alloc", alloc)
    M.decode_step = timed("decode", decode)
    for mod in (copy_kernel, pk, fk):
        mod.reset_counts()
    try:
        t0 = time.perf_counter()
        for rid, pr in enumerate(prompts):
            eng.submit(GenRequest(req_id=rid, prompt=pr, max_new=SERVE_NEW))
        outs = eng.run(max_steps=10 * SERVE_NEW * SERVE_REQUESTS)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        traffic_counts, traffic_clock = dict(counts), dict(clock)
        traffic = {**copy_kernel.LAUNCHES, **pk.LAUNCHES, **fk.LAUNCHES}
        st = dbs.stats(eng.state)
        for mod in (copy_kernel, pk, fk):
            mod.reset_counts()
        serving.dbs_copy_pool = copy
        fork = phase_fork_check(torch, cfg, params, dev, eng, prompts[0])
        fork_launches = {**copy_kernel.LAUNCHES, **pk.LAUNCHES,
                         **fk.LAUNCHES}
    finally:
        M.decode_step = inner["decode"]
        serving.dbs_copy_pool = inner["copy"]
        eng._prefill_one_host = inner["prefill"]
        eng._alloc_pages = inner["alloc"]
    plain = {**copy_kernel.PLAIN_CALLS, **pk.PLAIN_CALLS, **fk.PLAIN_CALLS}
    peak = torch.cuda.max_memory_allocated(dev)
    bad = [rid for rid in range(SERVE_REQUESTS)
           if len(outs.get(rid, [])) != SERVE_NEW]
    if bad:
        raise AssertionError(f"requests {bad} did not end with "
                             f"{SERVE_NEW} tokens")
    if st["volumes"] or st["extents_used"]:
        raise AssertionError(f"volumes or extents leaked: {st}")
    # where the baseline's decode step goes: eight requests fill the
    # slots; after admission and prefill, PROFILE_STEPS steps profiled
    for i in range(eng.n_slots):
        eng.submit(GenRequest(req_id=4000 + i, prompt=prompts[i],
                              max_new=2 + PROFILE_STEPS))
    eng.step()
    _profiled(torch, f"host baseline decode x{PROFILE_STEPS}",
              lambda: [eng.step() for _ in range(PROFILE_STEPS)], smi)
    eng.run(max_steps=4)
    st_fork = dbs.stats(eng.state)
    if st_fork["volumes"] or st_fork["extents_used"]:
        raise AssertionError(f"the fork check or the profile leaked: "
                             f"{st_fork}")
    if traffic["flash_attention"] <= 0 or traffic["paged_attention"]:
        raise AssertionError(f"the baseline's prefill must run the flash "
                             f"kernel and its decode the plain gather: "
                             f"{traffic}")
    want = len(_model_pools(eng))
    if fork_launches["dbs_copy"] <= 0 or fork_launches["dbs_copy"] % want:
        raise AssertionError(f"the fork's CoW launched dbs_copy "
                             f"{fork_launches['dbs_copy']} times, not a "
                             f"multiple of {want}")
    if any(plain.values()):
        raise AssertionError(f"plain versions ran on the card: {plain}")
    gen_tokens = SERVE_REQUESTS * SERVE_NEW
    emit(phase="serve_path", model=SERVE_MODEL, kv_backend="host", config=dict(
        kv_backend="host", n_slots=8, max_len=2048, n_queues=2,
        kernel="cuda", attn_impl="cuda", dtype="float32",
        page_blocks=cfg.page_blocks, n_extents=eng.volumes.engine.cfg.n_extents,
        pool_shape=list(_model_pools(eng)[0].shape),
        pools=len(_model_pools(eng))),
        requests=SERVE_REQUESTS, prompt_tokens=int(sum(len(p)
                                                       for p in prompts)),
        generated_tokens=gen_tokens, run_seconds=run_s,
        prefill_seconds=traffic_clock["prefill"],
        alloc_seconds=traffic_clock["alloc"],
        decode_seconds=traffic_clock["decode"],
        decode_steps=traffic_counts["decode_steps"],
        alloc_calls=traffic_counts["alloc_calls"],
        decode_tokens_per_s=gen_tokens / traffic_clock["decode"],
        tokens_per_s=gen_tokens / run_s, launches=traffic,
        fork_launches=fork_launches, dbs_copy_launches=(
            traffic["dbs_copy"] + fork_launches["dbs_copy"]),
        plain_calls=plain, dbs_stats=st, fork=fork,
        max_memory_allocated=peak, card=smi)
    return eng, kept, traffic["dbs_copy"], fork_launches["dbs_copy"]


def phase_copy_kernel_serve(torch, kept):
    """``dbs_copy`` at the serving baseline's width (pool (1032, 32, 4 *
    256) f32, 128 KiB rows) on the copies kept from its fork check, over a
    copy of the first kept pool."""
    if not kept:
        raise AssertionError("no dbs_copy inputs were kept on the serving "
                             "baseline")
    pool0 = kept[0][0]
    e, page = pool0.shape[:2]
    pool = pool0.reshape(e, page, -1).clone()
    calls = [(s.to(torch.int32), d.to(torch.int32), m.bool())
             for _p, s, d, m in kept]
    got = copy_parity(torch, pool, calls)
    emit(phase="kernel_parity", kernel="dbs_copy", width="serving baseline",
         pool_shape=list(pool.shape), calls=len(calls),
         lanes=int(calls[0][0].numel()), rows_copied=got["rows_copied"],
         resources=got["resources"], equal=True)
    del pool
    return got


# ---------------------------------------------------------------------------
# phase 15: the copy-based baseline against zero-copy
# ---------------------------------------------------------------------------
def phase_host_vs_zero(torch, dev, cfg, params, prompts):
    """Four requests, eight new tokens, on both backends with the logits
    recorded: logits within HOST_TOL (the zero-copy decode attends through
    the paged kernel over the engine pool, the baseline through the plain
    gather over its own pools: the sums run in other orders) and tokens
    equal. A step whose zero-copy top-2 logit margin is under TIE_MARGIN
    may pick either token; a request's later steps are then not compared
    (none is expected; the count is printed)."""
    import numpy as np
    from repro_torch.serving.engine import GenRequest
    outs = {}
    for kv in ("fused", "host"):
        eng = _serve_engine(torch, cfg, params, dev, record_logits=True,
                            kv_backend=kv)
        for rid in range(4):
            eng.submit(GenRequest(req_id=rid, prompt=prompts[rid],
                                  max_new=8))
        eng.run(max_steps=4 * 8)
        outs[kv] = {rid: (g.out_tokens, np.stack(g.logit_trace))
                    for rid, g in eng.live.items()}
        if kv == "fused":
            eng.volumes.close()
        del eng
        torch.cuda.empty_cache()
    worst, margin, ties, compared = 0.0, float("inf"), 0, 0
    for rid in range(4):
        (zt, zl), (ht, hl) = outs["fused"][rid], outs["host"][rid]
        for t in range(len(zt)):
            top = np.sort(zl[t])[-2:]
            margin = min(margin, float(top[1] - top[0]))
            worst = max(worst, float(np.abs(hl[t] - zl[t]).max()))
            np.testing.assert_allclose(hl[t], zl[t], **HOST_TOL)
            compared += 1
            if zt[t] != ht[t]:
                if top[1] - top[0] >= TIE_MARGIN:
                    raise AssertionError(
                        f"request {rid} step {t}: tokens {ht[t]} (host) "
                        f"and {zt[t]} (zero-copy) differ")
                ties += 1
                break
    emit(phase="host_vs_zero_copy", requests=4, new_tokens=8,
         steps_compared=compared, tolerance=HOST_TOL,
         max_abs_logit_diff=worst, min_top2_margin=margin,
         near_ties=ties, tokens_equal=ties == 0)


# ---------------------------------------------------------------------------
# phase 16: ServePool, two zero-copy shards
# ---------------------------------------------------------------------------
def phase_serve_pool(torch, dev, smi, cfg, params, prompts):
    """Two zero-copy ``ServeEngine`` shards (4 slots, max_len 512 each: a
    cut of the serve path's depth) behind ``ServePool``: five requests
    hashed across them, a fork after three steps that stays on its
    parent's shard; everything completes, every shard leak-free and its
    replicas consistent."""
    from repro_torch.configs.base import ExecutionPlan
    from repro_torch.core import dbs
    from repro_torch.serving.engine import GenRequest, ServePool
    pool = ServePool(cfg, params, n_shards=2, n_slots=4, max_len=512,
                     n_queues=2, kv_backend="fused", kv_replicas=2,
                     kernel="cuda", device=dev,
                     plan=ExecutionPlan(attn_impl="cuda",
                                        compute_dtype="float32"))
    t0 = time.perf_counter()
    for rid in range(5):
        pool.submit(GenRequest(req_id=rid, prompt=prompts[rid][:200],
                               max_new=6))
    for _ in range(3):
        pool.step()
    child = pool.fork(0, 10, max_new=2)
    if child is None or pool.shard_of(10) != pool.shard_of(0):
        raise AssertionError("the pool's fork did not stay on its parent's "
                             "shard")
    outs = pool.run(max_steps=40)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    if set(outs) != set(range(5)) | {10} or any(
            len(outs[r]) != 6 for r in range(5)) or not all(
            g.done for sh in pool.shards for g in sh.live.values()):
        raise AssertionError(f"the pool's requests did not complete: "
                             f"{ {r: len(v) for r, v in outs.items()} }")
    stats = [dbs.stats(sh.state) for sh in pool.shards]
    if any(st["volumes"] or st["extents_used"] for st in stats):
        raise AssertionError(f"a shard leaked: {stats}")
    for sh in pool.shards:
        sh.volumes.flush()
        if not sh.volumes.engine.backend.consistent():
            raise AssertionError("a shard's KV replicas disagree")
    emit(phase="serve_pool", shards=2, requests=5, forks=1,
         shard_of_fork=pool.shard_of(10),
         per_shard_requests=[len(sh.live) for sh in pool.shards],
         seconds=seconds, dbs_stats=stats, card=smi)
    for sh in pool.shards:
        sh.volumes.close()


# ---------------------------------------------------------------------------
# phases 17-18: RWKV-6 serving at rwkv6-3b's full width, and its kernel
# ---------------------------------------------------------------------------
def _reference_cannot_chunk(s: int) -> bool:
    """The reference's prefill reshapes s tokens into s // 256 equal chunks
    and fails unless that count divides s."""
    n = max(1, s // RWKV_REF_CHUNK)
    return s % n != 0


def _serve_one(torch, eng, rid, prompt):
    """Serve one request alone on ``eng`` with its logits recorded."""
    from repro_torch.serving.engine import GenRequest
    eng.record_logits = True
    eng.submit(GenRequest(req_id=rid, prompt=prompt.copy(),
                          max_new=SERVE_NEW))
    eng.run(max_steps=4 * SERVE_NEW)
    eng.record_logits = False
    return eng.live[rid]


def phase_serve_rwkv(torch, dev, smi):
    """``ServeEngine(kv_backend="host")`` serving rwkv6-3b at its published
    widths (fp32 weights from a seeded generator on the card), prefill and
    decode through the ``rwkv6_scan`` kernel: 16 requests (more than the 8
    slots, so slots are recycled), a fork check, a recycled-slot check
    against a fresh engine, and one decode step under sync-debug "error".
    Keeps the kernel's inputs from a few decode steps and from layer 0 of
    every prompt for phase 18."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ExecutionPlan
    from repro_torch.core import dbs
    from repro_torch.kernels.dbs import copy_kernel
    from repro_torch.kernels.rwkv6_scan import kernel as rk
    from repro_torch.models import init_params
    from repro_torch.models import model as M
    from repro_torch.serving.engine import GenRequest
    cfg = get_config(RWKV_MODEL)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(torch.Generator(device=dev).manual_seed(SEED), cfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = M.param_count_actual(params)
    eng = _serve_engine(torch, cfg, params, dev, kv_backend="host")
    rng = np.random.default_rng(SEED + 5)
    lens = rng.integers(SERVE_PROMPT[0], SERVE_PROMPT[1] + 1, SERVE_REQUESTS)
    if not any(_reference_cannot_chunk(int(n)) for n in lens):
        lens[-1] = 513          # a length the reference's prefill rejects
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in lens]

    clock = {"prefill": 0.0, "decode": 0.0}
    counts = {"decode_steps": 0, "prefills": 0, "layer": 0}
    kept = {"decode": [], "prefill": []}
    inner = {"prefill": eng._prefill_one_host, "decode": M.decode_step,
             "scan": rk.rwkv6_scan_fwd}

    def timed(name, fn, count):
        def run(*a, **k):
            counts[count] += 1
            counts["layer"] = 0
            t = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            clock[name] += time.perf_counter() - t
            return out
        return run

    def scan(r, k, v, logw, u, **kw):
        layer = counts["layer"]
        counts["layer"] += 1
        keep = None
        if r.shape[1] > 1 and layer == 0:
            keep = kept["prefill"]
        elif (r.shape[1] == 1 and layer < RWKV_KEEP_LAYERS
              and counts["decode_steps"] in SERVE_KEEP_STEPS):
            keep = kept["decode"]
        if keep is not None:
            s0 = kw.get("s0")
            keep.append(tuple(t.clone() for t in (r, k, v, logw, u))
                        + (None if s0 is None else s0.clone(),))
        return inner["scan"](r, k, v, logw, u, **kw)

    eng._prefill_one_host = timed("prefill", inner["prefill"], "prefills")
    M.decode_step = timed("decode", inner["decode"], "decode_steps")
    rk.rwkv6_scan_fwd = scan
    for mod in (rk, copy_kernel):
        mod.reset_counts()
    try:
        t0 = time.perf_counter()
        for rid, pr in enumerate(prompts):
            eng.submit(GenRequest(req_id=rid, prompt=pr, max_new=SERVE_NEW))
        outs = eng.run(max_steps=10 * SERVE_NEW * SERVE_REQUESTS)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        traffic_counts, traffic_clock = dict(counts), dict(clock)
        launches = dict(rk.LAUNCHES)
        copies = dict(copy_kernel.LAUNCHES)
    finally:
        eng._prefill_one_host = inner["prefill"]
        M.decode_step = inner["decode"]
        rk.rwkv6_scan_fwd = inner["scan"]
    peak = torch.cuda.max_memory_allocated(dev)
    st = dbs.stats(eng.state)
    bad = [rid for rid in range(SERVE_REQUESTS)
           if len(outs.get(rid, [])) != SERVE_NEW]
    if bad:
        raise AssertionError(f"requests {bad} did not end with "
                             f"{SERVE_NEW} tokens")
    if st["volumes"] or st["extents_used"]:
        raise AssertionError(f"volumes or extents leaked: {st}")
    want = cfg.n_layers * (traffic_counts["prefills"]
                           + traffic_counts["decode_steps"])
    if traffic_counts["prefills"] != SERVE_REQUESTS or \
            launches["rwkv6_scan"] != want:
        raise AssertionError(f"rwkv6_scan launched {launches} times, not "
                             f"{cfg.n_layers} per prompt and per decode "
                             f"step ({want})")
    if any(rk.PLAIN_CALLS.values()) or copies["dbs_copy"]:
        raise AssertionError(f"the plain scan ran ({rk.PLAIN_CALLS}) or "
                             f"dbs_copy launched ({copies}) on the RWKV path")
    # every slot has been recycled (and moved on by idle decode lanes): a
    # request served there against the same request in a fresh engine
    rid = 2000
    recycled = _serve_one(torch, eng, rid, prompts[0])
    fresh = _serve_engine(torch, cfg, params, dev, kv_backend="host")
    alone = _serve_one(torch, fresh, rid, prompts[0])
    del fresh
    if alone.out_tokens != recycled.out_tokens:
        raise AssertionError("a request in a recycled slot differs from the "
                             "same request served alone")
    recycle_diff = float(np.abs(np.stack(alone.logit_trace)
                                - np.stack(recycled.logit_trace)).max())
    fork = phase_fork_check(torch, cfg, params, dev, eng, prompts[0])
    # where the decode step goes: eight requests fill the slots; after
    # admission and prefill, PROFILE_STEPS steps profiled
    for i in range(eng.n_slots):
        eng.submit(GenRequest(req_id=4000 + i, prompt=prompts[i],
                              max_new=2 + PROFILE_STEPS))
    eng.step()
    _profiled(torch, f"rwkv6-3b decode x{PROFILE_STEPS}",
              lambda: [eng.step() for _ in range(PROFILE_STEPS)], smi)
    eng.run(max_steps=4)
    st_fork = dbs.stats(eng.state)
    if st_fork["volumes"] or st_fork["extents_used"]:
        raise AssertionError(f"the fork check or the profile leaked: "
                             f"{st_fork}")
    # one decode step never waits on the host
    last = torch.zeros((eng.n_slots,), dtype=torch.int64, device=dev)
    pos = torch.as_tensor(eng.pos, device=dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        M.decode_step(params, last, pos, cfg, eng.plan, eng.caches)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    gen_tokens = SERVE_REQUESTS * SERVE_NEW
    emit(phase="serve_path", model=RWKV_MODEL, kv_backend="host", config=dict(
        kv_backend="host", n_slots=8, max_len=2048, n_queues=2,
        attn_impl="cuda", dtype="float32", n_layers=cfg.n_layers,
        d_model=cfg.d_model, heads=cfg.d_model // cfg.ssm.rwkv_head_dim,
        head_dim=cfg.ssm.rwkv_head_dim, d_ff=cfg.d_ff,
        vocab=cfg.vocab_size, tie_embeddings=cfg.tie_embeddings),
        params=n_params, requests=SERVE_REQUESTS,
        prompt_tokens=int(lens.sum()),
        prompt_lengths=[int(x) for x in lens],
        reference_cannot_chunk=[int(x) for x in lens
                                if _reference_cannot_chunk(int(x))],
        generated_tokens=gen_tokens, init_seconds=init_s, run_seconds=run_s,
        prefill_seconds=traffic_clock["prefill"],
        decode_seconds=traffic_clock["decode"],
        decode_steps=traffic_counts["decode_steps"],
        decode_tokens_per_s=gen_tokens / traffic_clock["decode"],
        tokens_per_s=gen_tokens / run_s, launches=launches,
        launches_per_prompt=cfg.n_layers,
        launches_per_decode_step=cfg.n_layers,
        plain_calls=dict(rk.PLAIN_CALLS), dbs_copy_launches=copies["dbs_copy"],
        dbs_stats=st, recycled_slot_tokens_equal=True,
        recycled_max_logit_diff=recycle_diff, fork=fork,
        no_sync_decode_step=True, max_memory_allocated=peak, card=smi)
    return eng, params, kept, launches["rwkv6_scan"], traffic_counts


def phase_rwkv_kernel(torch, kept):
    """``rwkv6_scan`` against both plain versions (the chunked schedule and
    the step oracle) on the serve path's kept inputs and on crafted ones
    (ragged and prime lengths, a carried state, the decode batch), within
    RWKV_TOL; timed with CUDA graphs as in phase 3 on the kept decode and
    prefill calls, beside the bound."""
    from repro_torch.kernels.rwkv6_scan import (rwkv6_chunked_ref,
                                                rwkv6_scan_fwd, rwkv6_scan_ref)
    from repro_torch.kernels.rwkv6_scan.kernel import rwkv6_info, rwkv6_work
    from repro_torch.kernels.timing import graph_ms
    dec, pre = kept["decode"], kept["prefill"]
    if not dec or not pre:
        raise AssertionError("no rwkv6_scan inputs were kept")
    dev = dec[0][0].device
    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    crafted = []
    for b, s, h, d in ((1, 100, 40, 64), (1, 97, 40, 64), (8, 1, 40, 64),
                       (2, 131, 3, 32), (3, 61, 5, 16)):
        buf = torch.randn((b, s, 4, h, d), generator=gen, device=dev)
        buf[:, :, 3] = -torch.exp(buf[:, :, 3] * 0.5 - 1.0)
        r, k, v, logw = buf.unbind(2)
        u = torch.randn((h, d), generator=gen, device=dev) * 0.1
        s0 = torch.randn((b, h, d, d), generator=gen, device=dev)
        crafted.append((r, k, v, logw, u, s0))
    # strong decay (logw about -3 a token): a chunk's summed log decay is
    # below -88, where the chunked plain version's exp(-cum) overflows, so
    # these are held against the step oracle only
    strong = []
    for b, s, h, d in ((1, 300, 40, 64), (8, 1, 40, 64), (2, 97, 3, 32)):
        r, k, v = (torch.randn((b, s, h, d), generator=gen, device=dev)
                   for _ in range(3))
        logw = -3.0 - 0.2 * torch.rand((b, s, h, d), generator=gen,
                                       device=dev)
        u = torch.randn((h, d), generator=gen, device=dev) * 0.1
        s0 = torch.randn((b, h, d, d), generator=gen, device=dev)
        strong.append((r, k, v, logw, u, s0))
    err, scaled = {}, {}
    for name, calls in (("decode", dec), ("prefill", pre),
                        ("crafted", crafted)):
        e = es = 0.0
        for r, k, v, logw, u, s0 in calls:
            y, st = rwkv6_scan_fwd(r, k, v, logw, u, chunk=RWKV_CHUNK, s0=s0)
            z = s0 if s0 is not None else torch.zeros_like(st)
            for wy, ws in (rwkv6_chunked_ref(r, k, v, logw, u, s0,
                                             chunk=RWKV_CHUNK),
                           rwkv6_scan_ref(r, k, v, logw, u, z)):
                for got, want in ((y, wy), (st, ws)):
                    top = float(want.abs().max())
                    torch.testing.assert_close(
                        got, want, rtol=RWKV_RTOL,
                        atol=max(RWKV_ATOL, RWKV_ATOL_SCALE * top))
                    d = float((got - want).abs().max())
                    e, es = max(e, d), max(es, d / max(top, 1e-30))
        err[name], scaled[name] = e, es
    e = es = 0.0
    for r, k, v, logw, u, s0 in strong:
        y, st = rwkv6_scan_fwd(r, k, v, logw, u, chunk=RWKV_CHUNK, s0=s0)
        wy, ws = rwkv6_scan_ref(r, k, v, logw, u, s0)
        for got, want in ((y, wy), (st, ws)):
            if not bool(torch.isfinite(got).all()):
                raise AssertionError("rwkv6_scan: not finite under strong "
                                     "decay")
            top = float(want.abs().max())
            torch.testing.assert_close(
                got, want, rtol=RWKV_RTOL,
                atol=max(RWKV_ATOL, RWKV_ATOL_SCALE * top))
            dd = float((got - want).abs().max())
            e, es = max(e, dd), max(es, dd / max(top, 1e-30))
    err["strong_decay"], scaled["strong_decay"] = e, es
    timing = {}
    for name, calls in (("decode", dec), ("prefill", pre)):
        work = [rwkv6_work(*c[0].shape[:2], c[0].shape[2], c[0].shape[3],
                           RWKV_CHUNK, c[5] is not None) for c in calls]
        n = len(calls)
        ms = graph_ms(lambda: [rwkv6_scan_fwd(
            r, k, v, w, u, chunk=RWKV_CHUNK, s0=s0)
            for r, k, v, w, u, s0 in calls], n)
        plain = graph_ms(lambda: [rwkv6_chunked_ref(
            r, k, v, w, u, s0, chunk=RWKV_CHUNK)
            for r, k, v, w, u, s0 in calls], n)
        f = sum(w[0] for w in work) / n
        nb = sum(w[1] for w in work) / n
        op_s = sum(_rwkv_op_seconds(c[0].shape) for c in calls) / n
        b, s, h, d = calls[0][0].shape
        timing[name] = {"calls": n, "shape": list(calls[0][0].shape),
                        "kernel": rwkv6_info(b, s, h, d, RWKV_CHUNK),
                        "ms": ms, "plain_ms": plain, "flops_per_call": f,
                        "bytes_per_call": nb,
                        "bound_ms": max(op_s, nb / HBM_BYTES_PER_S) * 1e3,
                        "bound_by": ("operations" if op_s
                                     >= nb / HBM_BYTES_PER_S else "bytes")}
    bf16 = _rwkv_form16(torch, dec, pre, torch.bfloat16)
    f16 = _rwkv_form16(torch, dec, pre, torch.float16)
    emit(phase="kernel_parity", kernel="rwkv6_scan", chunk=RWKV_CHUNK,
         max_abs_err=err, max_err_over_largest_magnitude=scaled,
         crafted_shapes=[list(c[0].shape) for c in crafted],
         strong_decay_shapes=[list(c[0].shape) for c in strong],
         prefill_lengths=[int(c[0].shape[1]) for c in pre],
         tolerance={"rtol": RWKV_RTOL, "atol": f"max({RWKV_ATOL}, "
                    f"{RWKV_ATOL_SCALE} * max|reference|)"}, timing=timing)
    return {"name": "rwkv6_scan", "route": "cuda", "source": RWKV_SRC,
            "replaces": "src/repro/kernels/rwkv6_scan/kernel.py:66",
            "max_abs_err": max(err.values()), "timing": timing,
            "bf16": bf16, "f16": f16}


def _rwkv_form16(torch, dec, pre, dtype):
    """The scan's 16-bit form of ``dtype`` (bf16 or fp16) on the kept
    decode and prefill calls with r, k, v, logw and u rounded to ``dtype``
    (the carried state stays fp32), against the plain chunked version on
    the same inputs: the state within RWKV_TOL's terms; y (of ``dtype``)
    in bf16 within them plus one bf16 step of |y| (rtol 2^-7 more), in
    fp16 within the reference's fp16 tolerance (rtol 2e-3, atol 2e-3 or
    RWKV_ATOL_SCALE of the largest magnitude, the fp32 rule's widening);
    every launch of the form. Timed as the fp32 form, its bound at 2-byte
    inputs (the operations as _rwkv_op_seconds counts them). Emits a
    kernel_parity line; returns the numbers per schedule."""
    from repro_torch.kernels.rwkv6_scan import kernel as sk
    from repro_torch.kernels.rwkv6_scan import rwkv6_chunked_ref
    from repro_torch.kernels.rwkv6_scan.kernel import (rwkv6_info,
                                                       rwkv6_scan_fwd,
                                                       rwkv6_work)
    from repro_torch.kernels.timing import graph_ms
    out = {}
    key = str(dtype).split(".")[1]
    bf = dtype == torch.bfloat16
    y_rtol, y_atol = ((RWKV_RTOL + 2 ** -7, RWKV_ATOL) if bf
                      else (F16_ATTN_TOL["rtol"], F16_ATTN_TOL["atol"]))
    for name, kept in (("decode", dec), ("prefill", pre)):
        calls = [tuple(t.to(dtype) for t in c[:5]) + (c[5],)
                 for c in kept]
        e_y = e_s = 0.0
        sk.reset_counts()
        for r, k, v, w, u, s0 in calls:
            y, st = rwkv6_scan_fwd(r, k, v, w, u, chunk=RWKV_CHUNK, s0=s0)
            wy, ws = rwkv6_chunked_ref(r, k, v, w, u, s0, chunk=RWKV_CHUNK)
            if y.dtype != dtype or st.dtype != torch.float32:
                raise AssertionError(f"rwkv6_scan {key}: y {y.dtype}, state "
                                     f"{st.dtype}")
            for got, want, rtol, atol in ((y, wy, y_rtol, y_atol),
                                          (st, ws, RWKV_RTOL, RWKV_ATOL)):
                top = float(want.float().abs().max())
                torch.testing.assert_close(
                    got.float(), want.float(), rtol=rtol,
                    atol=max(atol, RWKV_ATOL_SCALE * top))
            e_y = max(e_y, _max_err(torch, y, wy))
            e_s = max(e_s, _max_err(torch, st, ws))
        if sk.LAUNCHES_BY_DTYPE[key] != len(calls) or \
                sk.LAUNCHES["rwkv6_scan"] != len(calls):
            raise AssertionError(f"rwkv6_scan {key}: launches "
                                 f"{sk.LAUNCHES_BY_DTYPE}, not {len(calls)} "
                                 f"of the {key} form")
        work = [rwkv6_work(*c[0].shape[:2], c[0].shape[2], c[0].shape[3],
                           RWKV_CHUNK, c[5] is not None, 2) for c in calls]
        n = len(calls)
        ms = graph_ms(lambda: [rwkv6_scan_fwd(
            r, k, v, w, u, chunk=RWKV_CHUNK, s0=s0)
            for r, k, v, w, u, s0 in calls], n)
        plain = graph_ms(lambda: [rwkv6_chunked_ref(
            r, k, v, w, u, s0, chunk=RWKV_CHUNK)
            for r, k, v, w, u, s0 in calls], n)
        f = sum(x[0] for x in work) / n
        nb = sum(x[1] for x in work) / n
        op_s = sum(_rwkv_op_seconds(c[0].shape) for c in calls) / n
        b, s, h, d = calls[0][0].shape
        out[name] = {"calls": n, "shape": list(calls[0][0].shape),
                     "kernel": rwkv6_info(b, s, h, d, RWKV_CHUNK,
                                           dtype=dtype),
                     "ms": ms, "plain_ms": plain, "library_ms": None,
                     "max_abs_err": max(e_y, e_s), "max_abs_err_y": e_y,
                     "max_abs_err_state": e_s, "flops_per_call": f,
                     "bytes_per_call": nb,
                     "bound_ms": max(op_s, nb / HBM_BYTES_PER_S) * 1e3,
                     "bound_by": ("operations" if op_s
                                  >= nb / HBM_BYTES_PER_S else "bytes")}
    emit(phase="kernel_parity", kernel="rwkv6_scan", dtype=key,
         inputs=f"the kept calls rounded to {key} (u too; the state fp32)",
         tolerance={"rtol": f"{RWKV_RTOL} (y: {y_rtol})",
                    "atol": f"max({RWKV_ATOL} (y: {y_atol}), "
                            f"{RWKV_ATOL_SCALE} * max|reference|)"},
         timing=out)
    return out


def _rwkv_op_seconds(shape) -> float:
    """The least time the scan's operations (rwkv6_work's count) take on
    the card, each at the rate of the units that run it. The decode
    schedule runs all of them on the CUDA cores (fp32). The prefill runs
    its four products on the tensor cores in 3xTF32 (the inter-chunk read,
    the state update, att . v and the intra-chunk matrix but for its
    diagonal triangles) and on the CUDA cores only the bonus and, in each
    16-token sub-chunk (rwkv6_scan.cu kSub), the pairs inside its two
    8-token halves (the lower-left quadrant is one more product)."""
    from repro_torch.kernels.rwkv6_scan.kernel import (rwkv6_schedule,
                                                       rwkv6_work)
    b, s, h, d = shape
    total = rwkv6_work(b, s, h, d, RWKV_CHUNK, False)[0]
    if rwkv6_schedule(s) == "decode":
        return total / FP32_FLOPS_PER_S
    pairs = 0
    for c0 in range(0, s, RWKV_CHUNK):
        n = min(RWKV_CHUNK, s - c0)
        for a0 in range(0, n, 16):
            m = min(16, n - a0)
            lo, hi = min(m, 8), max(m - 8, 0)
            pairs += lo * (lo - 1) // 2 + hi * (hi - 1) // 2
    simt = 2 * b * h * d * (pairs + s)
    return simt / FP32_FLOPS_PER_S + (total - simt) / TF32X3_FLOPS_PER_S


def _rwkv_entry(k, launches, counts, n_layers):
    """The kernels-line entry: ms, plain_ms and bound_ms per launch over the
    serve path's mix (n_layers launches per prompt and per decode step),
    from the prefill and decode timings."""
    t = k.pop("timing")
    n_pre = n_layers * counts["prefills"]
    n_dec = n_layers * counts["decode_steps"]

    def mix(key):
        return (n_pre * t["prefill"][key] + n_dec * t["decode"][key]) / (
            n_pre + n_dec)
    # what bounds the mix: the kind of call that holds most of its bound
    major = max(("prefill", n_pre), ("decode", n_dec),
                key=lambda kn: kn[1] * t[kn[0]]["bound_ms"])[0]
    pk = t["prefill"]["kernel"]
    k.update(launches=launches, launches_prefill=n_pre,
             launches_decode=n_dec, kernels_per_call=1,
             n_col=pk["n_col"], registers=pk["registers"],
             dynamic_smem=pk["dynamic_smem"],
             blocks_per_sm=pk["blocks_per_sm"], ms=mix("ms"),
             plain_ms=mix("plain_ms"),
             bound_ms=mix("bound_ms"), bound_by=t[major]["bound_by"],
             library_ms=None,
             library_call="none: no single PyTorch call computes the RWKV-6 "
                          "recurrence",
             prefill=t["prefill"], decode=t["decode"])
    for tag in ("bf16", "f16"):
        t16 = k.pop(tag)
        k.update(**_width_keys(f"{tag}_prefill", t16["prefill"]),
                 **_width_keys(f"{tag}_decode", t16["decode"]))
    return k


# ---------------------------------------------------------------------------
# phases 19-20: the hybrid and MoE families at full width
# ---------------------------------------------------------------------------
def _prompt(rng, cfg, n):
    """``n`` token ids drawn from ``rng``: (n,), or (n, K) on a K-codebook
    net (the same draws as (n,) for one codebook)."""
    k = cfg.n_codebooks
    return rng.integers(0, cfg.vocab_size, (n, k) if k > 1 else n)


def _family_prompts(np, cfg, seed, hybrid, lengths=SERVE_PROMPT):
    """SERVE_REQUESTS prompts drawn in ``lengths``; on the hybrid model
    the requests of HYBRID_AT take two lengths past the window and 513."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(lengths[0], lengths[1] + 1, SERVE_REQUESTS)
    if hybrid:
        for i, kind in HYBRID_AT.items():
            lens[i] = (513 if kind == "513" else
                       rng.integers(HYBRID_LONG[0], HYBRID_LONG[1] + 1))
    return lens, [_prompt(rng, cfg, n) for n in lens]


def _device_us(e) -> float:
    """A profiler event's device time with its children's (the attribute's
    name moved between torch releases)."""
    v = getattr(e, "device_time_total", None)
    return float(v if v is not None else e.cuda_time_total)


def _decode_split(torch, eng, smi, name, lengths=SERVE_PROMPT):
    """Eight requests fill the slots; after two warm-up steps (admission
    and prefill ride the first) PROFILE_STEPS decode steps are timed, then
    one runs under ``torch.profiler`` with the attention (KV writes and
    the read, every cache kind), the Mamba branch and the MoE MLP each in a
    ``record_function`` range: the device time of each range's kernels,
    the rest, and the step's kernels. The engine then drains."""
    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.core import dbs
    from repro_torch.models import blocks as B
    from repro_torch.models import ssm
    from repro_torch.serving.engine import GenRequest
    rng = np.random.default_rng(SEED + 8)
    for i in range(eng.n_slots):
        n = int(rng.integers(lengths[0], lengths[1] + 1))
        eng.submit(GenRequest(req_id=5000 + i, prompt=_prompt(
            rng, eng.cfg, n), max_new=3 + PROFILE_STEPS))
    for _ in range(2):
        eng.step()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(PROFILE_STEPS):
        eng.step()
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t) / PROFILE_STEPS
    parts = {"attention": (B, "_decode_attention"),
             "mamba": (ssm, "mamba_step"), "moe": (B, "apply_moe")}
    inner = {label: getattr(mod, attr) for label, (mod, attr)
             in parts.items()}

    def ranged(label, fn):
        def run(*a, **k):
            with record_function(label):
                return fn(*a, **k)
        return run
    for label, (mod, attr) in parts.items():
        setattr(mod, attr, ranged(label, inner[label]))
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            eng.step()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
    finally:
        for label, (mod, attr) in parts.items():
            setattr(mod, attr, inner[label])
    events = prof.events()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and e.name not in parts]
    total = sum(e.time_range.end - e.time_range.start for e in kernels) / 1e3
    split = {label: sum(_device_us(e) for e in events
                        if e.name == label
                        and e.device_type == DeviceType.CPU) / 1e3
             for label in parts}
    ranges = {label: sum(1 for e in events if e.name == label
                         and e.device_type == DeviceType.CPU)
              for label in parts}
    split["rest"] = total - sum(split.values())
    emit(phase="profile", part=f"{name} decode step, split", slots=eng.n_slots,
         decode_step_s=step_s, profiled_step_wall_s=wall,
         device_kernel_ms=total, device_ms_by_part=split,
         ranges_by_part=ranges, kernels_a_step=len(kernels),
         device_idle_share=1.0 - total / 1e3 / wall, card=smi)
    eng.run(max_steps=PROFILE_STEPS + 4)
    st = dbs.stats(eng.state)
    if not all(r.done for r in eng.live.values()) or st["volumes"]:
        raise AssertionError(f"the profiled requests did not drain: {st}")
    return {"decode_step_s": step_s, "kernels_a_step": len(kernels),
            "device_kernel_ms": total, "device_ms_by_part": split}


@contextlib.contextmanager
def _moe_record(torch, record):
    """While open, every MoE call appends (form, tokens, start, end): its
    form (``layers._moe_every`` or ``_moe_grouped``, the one ``moe_form``
    picked), its token count and CUDA events around it."""
    from repro_torch.models import layers
    inner = {f: getattr(layers, f"_moe_{f}") for f in ("every", "grouped")}

    def wrap(form):
        def run(p, xf, *a, **k):
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            out = inner[form](p, xf, *a, **k)
            end.record()
            record.append((form, int(xf.shape[0]), start, end))
            return out
        return run
    for form in inner:
        setattr(layers, f"_moe_{form}", wrap(form))
    try:
        yield record
    finally:
        for form, fn in inner.items():
            setattr(layers, f"_moe_{form}", fn)


def _moe_summary(torch, record, n_slots):
    """Calls, tokens and device ms (the span between the call's events)
    by path (a call of at most ``n_slots`` tokens is a decode step's, the
    rest prefill's) and form."""
    torch.cuda.synchronize()
    out = {}
    for form, t, start, end in record:
        path = "decode" if t <= n_slots else "prefill"
        e = out.setdefault(f"{path}/{form}", {"calls": 0, "tokens": 0,
                                              "device_ms": 0.0})
        e["calls"] += 1
        e["tokens"] += t
        e["device_ms"] += start.elapsed_time(end)
    return out


@contextlib.contextmanager
def _keep_split_calls(torch, n_paged, kept, step=SERVE_KEEP_STEPS[0]):
    """While open, the copy-based baseline's plain paged decode (``models.
    attention.paged_decode_attention``, after the new token's write into
    the model-owned split pools) keeps the inputs of the first
    FAMILY_KEEP_LAYERS paged layers of its ``step``-th decode step, in the
    split-pool kernel's form: (q (B,H,d), pool_k and pool_v copies, the
    block table, lengths = position + 1, kw)."""
    from repro_torch.models import attention as A
    inner = A.paged_decode_attention
    seen = [0]

    def run(q, pool_k, pool_v, block_table, q_pos, *, window=0,
            logit_cap=0.0, scale=None, **kw):
        first = n_paged * step
        if first <= seen[0] < first + min(n_paged, FAMILY_KEEP_LAYERS):
            kept.append((q[:, 0].contiguous(), pool_k.clone(),
                         pool_v.clone(),
                         block_table.to(torch.int32).contiguous(),
                         (q_pos[:, 0] + 1).to(torch.int32),
                         dict(window=window, logit_cap=logit_cap,
                              scale=scale)))
        seen[0] += 1
        return inner(q, pool_k, pool_v, block_table, q_pos, window=window,
                     logit_cap=logit_cap, scale=scale, **kw)
    A.paged_decode_attention = run
    try:
        yield kept
    finally:
        A.paged_decode_attention = inner


def phase_paged_split_kernel(torch, kept):
    """``paged_attention_fwd``, the split-pool entry, on the baseline decode
    calls ``_keep_split_calls`` kept (deepseek-v3: K 576 and V 512 wide on
    one latent KV head, 128 query heads; musicgen: 32 heads of 64) against
    its plain version within ATTN_TOL, timed as in phase 10 beside the
    bound (live K and V rows, q and the output over 3.35 TB/s) and two
    ``index_select`` gathers with SDPA."""
    import torch.nn.functional as F
    from repro_torch.kernels.paged_attention import (paged_attention_fwd,
                                                     paged_attention_ref)
    from repro_torch.kernels.paged_attention.kernel import (
        paged_block_rows, paged_form, paged_info, paged_splits, paged_work,
        sm_count)
    from repro_torch.kernels.timing import graph_ms
    if not kept:
        raise AssertionError("no baseline decode call was kept")
    err, n_bytes, flops, lib_in = 0.0, [], [], []
    for q, pk, pv, table, lengths, kw in kept:
        got = paged_attention_fwd(q, pk, pv, table, lengths, **kw)
        want = paged_attention_ref(q, pk, pv, table, lengths, **kw)
        torch.testing.assert_close(got, want, **ATTN_TOL)
        err = max(err, float((got - want).abs().max()))
        b, h, d = q.shape
        _e, page, kv, dv = pv.shape
        f, nb = paged_work(q, table, lengths, page, kv, d, dv, kw["window"])
        flops.append(f)
        n_bytes.append(nb)
        p_max = table.shape[1]
        pos = torch.arange(p_max * page, device=q.device)
        valid = (pos[None, :] < lengths[:, None]) & (
            table >= 0).repeat_interleave(page, dim=1)
        lib_in.append((q.reshape(b, pk.shape[2], -1, d), table.clamp(
            min=0).reshape(-1).long(), valid[:, None, None, :], pk, pv, b,
            p_max))
    n = len(kept)
    ms = graph_ms(lambda: [paged_attention_fwd(*c[:5], **c[5])
                           for c in kept], n)
    plain = graph_ms(lambda: [paged_attention_ref(*c[:5], **c[5])
                              for c in kept], n)

    def library():
        for q4, idx, mask, pk, pv, b, p_max in lib_in:
            kk = pk.index_select(0, idx).reshape(
                b, p_max * pk.shape[1], pk.shape[2], -1).transpose(1, 2)
            vv = pv.index_select(0, idx).reshape(
                b, p_max * pv.shape[1], pv.shape[2], -1).transpose(1, 2)
            F.scaled_dot_product_attention(q4, kk, vv, attn_mask=mask)
    lib = graph_ms(library, n)
    q, pk, pv, table = kept[0][:4]
    b, h, d = q.shape
    kv, dv, p_max = pk.shape[2], pv.shape[3], table.shape[1]
    rows = b * paged_block_rows(h, kv, d, dv)
    n_split = paged_splits(p_max, rows, sm_count(q.device), h // kv,
                           max(d, dv))
    info = paged_info(h // kv, d, dv, True, True, p_max, n_split)
    mean_b, mean_f = sum(n_bytes) / n, sum(flops) / n
    instance = paged_form(h // kv, d, dv)
    rate = FP32_FLOPS_PER_S if instance == "lanes" else TF32X3_FLOPS_PER_S
    t_b, t_f = mean_b / HBM_BYTES_PER_S, mean_f / rate
    emit(phase="kernel_parity", kernel="paged_attention",
         entry="split pools (copy-based baseline)", calls=n,
         q_shape=list(q.shape), pool_k_shape=list(pk.shape),
         pool_v_shape=list(pv.shape), max_abs_err=err,
         bytes_per_call=mean_b, flops_per_call=mean_f, splits=n_split,
         instance=instance, tolerance=ATTN_TOL)
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain,
            "bound_ms": max(t_b, t_f) * 1e3,
            "bound_by": "bytes" if t_b >= t_f else "operations",
            "library_ms": lib, "bytes_per_call": mean_b,
            "flops_per_call": mean_f, "splits": n_split,
            "calls": n, "resources": resources(torch, info, rows * n_split)}


@contextlib.contextmanager
def _route_replay(torch, routes, replay):
    """While open, every MoE router call records its top-k experts in
    ``routes`` (``replay`` False) or takes them from ``routes`` in call
    order (``replay`` True), recomputing their combine weights from its own
    logits, as ``layers._moe_route`` does."""
    from repro_torch.models import layers
    inner = layers._moe_route
    calls = [0]

    def run(p, xf, cfg):
        logits, top_idx, top_w = inner(p, xf, cfg)
        if not replay:
            routes.append(top_idx)
            return logits, top_idx, top_w
        mine, top_idx = top_idx, routes[calls[0]]
        calls[0] += 1
        routes.append(int((mine != top_idx).any(dim=-1).sum()))
        if cfg.moe.router_aux_free:
            top_gate = torch.gather(torch.sigmoid(logits), -1, top_idx)
            top_w = top_gate / (top_gate.sum(-1, keepdim=True) + 1e-9)
        else:
            top_w = torch.softmax(torch.gather(logits, -1, top_idx), -1)
        return logits, top_idx, top_w
    layers._moe_route = run
    try:
        yield routes
    finally:
        layers._moe_route = inner


def phase_mtp(torch, cfg, params, dev, smi):
    """deepseek-v3's MTP head on the serving phase's weights: ``forward``
    over one MTP_PROMPT-token prompt, then ``mtp_hidden``, on
    ``attn_impl="cuda"`` (the flash kernel, once a layer and once in the
    MTP block) and on ``"dense"`` (the plain attention; no kernel), each
    timed between synchronisations. Both results must be finite, of shape
    (1, S, D) and (1, S - 1, D), and agree within HOST_TOL. The dense run
    takes the kernel run's top-8 experts at every token (its own combine
    weights): a 256-way router may pick another expert on a difference of
    1e-6 in its logits, which is not the attention's error; the tokens the
    dense run would route otherwise are counted. Returns the flash
    launches."""
    import numpy as np
    from repro_torch.configs.base import ExecutionPlan
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.models import forward, mtp_hidden
    tok = torch.as_tensor(np.random.default_rng(SEED + 11).integers(
        0, cfg.vocab_size, (1, MTP_PROMPT)), device=dev)
    out, secs, launches, plain, routes = {}, {}, {}, {}, []
    for impl in ("cuda", "dense"):
        plan = ExecutionPlan(attn_impl=impl, compute_dtype="float32")
        fk.reset_counts()
        with _route_replay(torch, routes, replay=impl == "dense"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            h, _ = forward(params, tok, cfg, plan)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            m = mtp_hidden(params, h, tok, cfg, plan)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
        out[impl] = (h, m)
        secs[impl] = {"forward": t1 - t0, "mtp_hidden": t2 - t1}
        launches[impl] = fk.LAUNCHES["flash_attention"]
        plain[impl] = fk.PLAIN_CALLS["flash_attention"]
    flips = [r for r in routes if isinstance(r, int)]
    (h, m), (hd, md) = out["cuda"], out["dense"]
    if h.shape != (1, MTP_PROMPT, cfg.d_model) or m.shape != (
            1, MTP_PROMPT - 1, cfg.d_model):
        raise AssertionError(f"mtp: shapes {h.shape}, {m.shape}")
    if not (torch.isfinite(h).all() and torch.isfinite(m).all()):
        raise AssertionError("mtp: non-finite hidden states")
    if launches != {"cuda": cfg.n_layers + 1, "dense": 0} or any(
            plain.values()):
        raise AssertionError(f"mtp: flash launches {launches}, plain "
                             f"{plain}: not one a layer and one in the "
                             f"MTP block on the cuda route")
    torch.testing.assert_close(h, hd, **HOST_TOL)
    torch.testing.assert_close(m, md, **HOST_TOL)
    emit(phase="mtp", model=cfg.name, n_layers=cfg.n_layers,
         prompt_tokens=MTP_PROMPT, seconds=secs, flash_launches=launches,
         tolerance=HOST_TOL,
         max_abs_diff_hidden=float((h - hd).abs().max()),
         max_abs_diff_mtp=float((m - md).abs().max()),
         moe_layers_replayed=len(flips),
         tokens_routed_otherwise_by_dense=flips, card=smi)
    return launches["cuda"]


def phase_serve_family(torch, dev, smi, model, seed, n_layers=None,
                       max_len=2048, lengths=SERVE_PROMPT, mtp=False):
    """Zero-copy serving of one model at its published widths (fp32 weights
    from a seeded generator on the card; its depth cut to ``n_layers``
    where given), phase 9's engine (``fused``, 2 KV replicas, 8 slots,
    ``max_len``, the flash kernel in prefill, the paged kernel in decode,
    the DBS kernels in the KV pumps): 16 requests (slots recycled) with
    prompts drawn in ``lengths``, of 32 new tokens, run, checked and their
    kept kernel calls held against the plain versions as in phases 9-10
    (``_serve_traffic``). Then: the last request (a recycled slot) equals a
    fresh engine's; the fork check of phase 9; one decode step under
    sync-debug "error"; a profiled decode step's split; and the
    copy-based baseline on the same prompts gives the same tokens
    (TIE_MARGIN rule, with the zero-copy run's top-2 margins), whose
    split-pool decode calls of one step are kept and held against the
    split-pool entry (``<tag>_split`` keys). Nothing but FAMILY_HELD_BYTES
    may be allocated at the start. On an MoE model the form each MoE call
    took is recorded with its device ms; with ``mtp``, ``phase_mtp`` runs
    on the same weights. Returns the traffic's launches and the
    kernel-parity results."""
    import dataclasses

    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.core import dbs
    from repro_torch.kernels.dbs import copy_kernel
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.paged_attention import kernel as pk
    from repro_torch.models import init_params
    from repro_torch.models import model as M
    from repro_torch.serving.engine import GenRequest
    cfg = get_config(model)
    reduced = {}
    if n_layers is not None:
        reduced["n_layers"] = [cfg.n_layers, n_layers]
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    if max_len != 2048:
        reduced["max_len"] = [2048, max_len]
    hybrid = cfg.ssm is not None
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated(dev)
    if held >= FAMILY_HELD_BYTES:
        raise AssertionError(f"{model}: {held} bytes still allocated before "
                             f"the phase: an earlier engine or model lives")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(torch.Generator(device=dev).manual_seed(SEED), cfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = M.param_count_actual(params)
    lens, prompts = _family_prompts(np, cfg, seed, hybrid, lengths)
    eng = _serve_engine(torch, cfg, params, dev, max_len=max_len)

    def keep_flash(kept, q, kw):
        # hymba: the first prompt past the window, one global and one
        # windowed layer; granite-moe: layer 0 of two prompts
        sq, seen = q.shape[2], [(c[0].shape[2], c[3]["window"])
                                for c in kept]
        return len(kept) < 2 and (
            (hybrid and sq > cfg.sliding_window
             and all(s == sq and w != kw["window"] for s, w in seen))
            or (not hybrid and all(s != sq for s, _ in seen)))
    moe_calls = []
    with (_moe_record(torch, moe_calls) if cfg.moe is not None
          else contextlib.nullcontext()):
        res = _serve_traffic(torch, eng, prompts, keep_flash,
                             keep_layers=FAMILY_KEEP_LAYERS)
    # every decode call of the instantiation its shapes pick (deepseek-v3's
    # 128 query heads on a 576-wide latent: the packed one)
    q0, pool0 = res["kept_paged"][0][0], eng._pools[0]
    paged_instance = pk.paged_form(q0.shape[1] // pool0.shape[3],
                                   q0.shape[2], pool0.shape[4])
    by_instance = res["launches_by_form"]["paged_attention"]
    if by_instance[paged_instance] != res["launches"]["paged_attention"]:
        raise AssertionError(f"{model}: paged launches {by_instance}, not "
                             f"the {paged_instance} instantiation alone")
    # fp32 prefill: the wgmma form at d = dv 64, 128, 256; MLA's 576 / 512
    # the mma.sync one
    _flash_form_is(model, res, "float32" if cfg.mla is not None
                   else "f32_wgmma")
    del q0, pool0
    moe_forms = (_moe_summary(torch, moe_calls, eng.n_slots)
                 if cfg.moe is not None else None)
    del moe_calls
    fused_tokens = {rid: list(toks) for rid, toks in res["outs"].items()}
    config = _serve_config(
        cfg, eng, n_layers=cfg.n_layers, d_model=cfg.d_model,
        heads=cfg.n_heads, kv_heads=cfg.n_kv_heads,
        head_dim=cfg.resolved_head_dim, d_ff=cfg.d_ff, vocab=cfg.vocab_size,
        sliding_window=cfg.sliding_window,
        global_layers=list(cfg.global_layer_indices),
        ssm=None if cfg.ssm is None else dict(
            state_dim=cfg.ssm.state_dim, expand=cfg.ssm.expand,
            conv_kernel=cfg.ssm.conv_kernel),
        moe=None if cfg.moe is None else dict(
            n_experts=cfg.moe.n_experts, top_k=cfg.moe.top_k,
            d_ff_expert=cfg.moe.d_ff_expert, n_shared=cfg.moe.n_shared,
            dense_layers=cfg.n_dense_layers),
        mla=None if cfg.mla is None else dataclasses.asdict(cfg.mla),
        mtp_depth=cfg.mtp_depth, codebooks=cfg.n_codebooks,
        prompt_lengths_drawn_in=list(lengths), reduced=reduced)

    # the last request ran in a recycled slot: a fresh engine, same prompt
    rid = SERVE_REQUESTS - 1
    fresh = _serve_engine(torch, cfg, params, dev, record_logits=True,
                          max_len=max_len)
    alone = _serve_one(torch, fresh, rid, prompts[rid])
    fresh.volumes.close()
    del fresh
    gc.collect()             # musicgen's engine holds 26 GB of pools
    torch.cuda.empty_cache()
    recycle_ties = _tokens_match(
        {rid: fused_tokens[rid]}, {rid: alone.out_tokens},
        {(rid, t): _margin_np(np, lg) for t, lg in
         enumerate(alone.logit_trace)}, f"{model}: the recycled slot")
    fork = phase_fork_check(torch, cfg, params, dev, eng, prompts[0])
    phase_no_sync_serve(torch, eng)
    split = _decode_split(torch, eng, smi, model, lengths)
    longest = int(np.argmax(lens))
    eng.volumes.close()
    del eng
    gc.collect()
    torch.cuda.empty_cache()

    # the copy-based baseline on the same prompts
    host = _serve_engine(torch, cfg, params, dev, kv_backend="host",
                         max_len=max_len)
    for mod in (pk, fk, copy_kernel):
        mod.reset_counts()
    kept_split = []
    n_paged = sum(c is not None and "pool_k" in c for c in host.caches)
    t0 = time.perf_counter()
    with _keep_split_calls(torch, n_paged, kept_split):
        for r, pr in enumerate(prompts):
            host.submit(GenRequest(req_id=r, prompt=pr, max_new=SERVE_NEW))
        host_outs = host.run(max_steps=10 * SERVE_NEW * SERVE_REQUESTS)
        torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    host_launches = {**copy_kernel.LAUNCHES, **pk.LAUNCHES, **fk.LAUNCHES}
    host_plain = {**copy_kernel.PLAIN_CALLS, **pk.PLAIN_CALLS,
                  **fk.PLAIN_CALLS}
    host_st = dbs.stats(host.state)
    host.volumes.close()
    del host
    host_ties = _tokens_match(host_outs, fused_tokens, res["margin_of"],
                              f"{model}: the copy-based baseline")
    if host_st["volumes"] or host_st["extents_used"] or any(
            host_plain.values()) or host_launches["flash_attention"] <= 0:
        raise AssertionError(f"{model} baseline: {host_st}, launches "
                             f"{host_launches}, plain {host_plain}")
    split_k = phase_paged_split_kernel(torch, kept_split)
    del kept_split
    torch.cuda.empty_cache()
    mtp_launches = (phase_mtp(torch, cfg, params, dev, smi) if mtp
                    else None)
    gen_tokens = SERVE_REQUESTS * SERVE_NEW
    prefill_s = res["prefill_s"]
    emit(phase="serve_path", model=model, config=config, params=n_params,
         **_serve_fields(lens, res), init_seconds=init_s,
         prefill_seconds_by_length={
             **({"513": prefill_s[int(np.flatnonzero(lens == 513)[0])]}
                if hybrid else {}),
             f"longest ({int(lens[longest])})": prefill_s[longest]},
         launches_per_decode_step={
             "paged_attention": config["paged_layers"],
             "all kernels (profiled step)": split["kernels_a_step"]},
         recycled_slot_near_ties=recycle_ties, fork=fork,
         no_sync_decode_step=True, decode_split=split, moe_forms=moe_forms,
         host_baseline=dict(run_seconds=host_s,
                            tokens_per_s=gen_tokens / host_s,
                            tokens_equal_zero_copy=host_ties == 0,
                            near_ties=host_ties, launches=host_launches),
         max_memory_allocated_phase=torch.cuda.max_memory_allocated(dev),
         memory_allocated_before=held, card=smi)
    del params
    return {"launches": res["launches"], "split": split_k,
            "paged_by_instance": by_instance,
            "flash_by_form": res["launches_by_form"]["flash_attention"],
            "mtp_flash_launches": mtp_launches, **res["parity"]}


# ---------------------------------------------------------------------------
# phases 24-26: training and checkpoints
# ---------------------------------------------------------------------------
def _kernel_modules():
    """The six kernels' wrapper modules (their LAUNCHES, PLAIN_CALLS)."""
    from repro_torch.kernels.dbs import copy_kernel, rw_kernel
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.paged_attention import kernel as pk
    from repro_torch.kernels.rwkv6_scan import kernel as rk
    return (rw_kernel, copy_kernel, pk, fk, rk)


def _scaled_err(torch, got, want) -> float:
    """The largest of each leaf pair's max |difference| over the leaf's
    largest magnitude (got on any device, want on the CPU)."""
    worst = 0.0
    for a, b in zip(got, want):
        scale = float(b.abs().max()) or 1.0
        worst = max(worst, float((a.cpu() - b).abs().max()) / scale)
    return worst


def phase_train_parity(torch, dev, smi):
    """Phase 24: one train step of gemma2-2b at full width cut to
    PARITY_LAYERS layers (one local, one global) on the card and on the CPU
    from the same seeded params and batch, the launch plan (remat "block",
    fp32, chunked attention): loss, grad_norm and every parameter's
    gradient, then AdamW on the card's gradients in both places. Returns
    the params, the batch and the CPU's gradients, on the CPU (phase 24b
    holds the bf16 plan's gradients against these; phase 26 checkpoints
    the params)."""
    import dataclasses

    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ExecutionPlan
    from repro_torch.models import init_params
    from repro_torch.models.model import param_count_actual
    from repro_torch.models.model import tree_leaves, tree_map
    from repro_torch.training.optimizer import global_norm, make_optimizer
    from repro_torch.training.train_step import grads_of
    full = get_config(TRAIN_MODEL)
    cfg = dataclasses.replace(full, n_layers=PARITY_LAYERS)
    kinds = sorted(cfg.layer_kind(i) for i in range(cfg.n_layers))
    if kinds != ["global", "local"]:
        raise AssertionError(f"parity cut's layers: {kinds}")
    plan = ExecutionPlan(remat="block", compute_dtype="float32",
                         logits_chunk=0)
    params = init_params(torch.Generator().manual_seed(SEED + 11), cfg)
    ids = np.random.default_rng(SEED + 11).integers(
        0, cfg.vocab_size, (PARITY_BATCH, PARITY_SEQ + 1))
    batch = {"tokens": torch.from_numpy(ids[:, :-1]),
             "labels": torch.from_numpy(ids[:, 1:])}
    out, secs = {}, {}
    for where, d in (("card", dev), ("cpu", torch.device("cpu"))):
        p = tree_map(lambda t, d=d: t.to(d, copy=True), params)
        b = {k: v.to(d) for k, v in batch.items()}
        t0 = time.perf_counter()
        g, m = grads_of(p, b, cfg, plan)
        norm = global_norm(g)
        float(norm)
        secs[where] = time.perf_counter() - t0
        out[where] = (p, g, m, norm)
    (p_d, g_d, m_d, n_d), (p_c, g_c, m_c, n_c) = out["card"], out["cpu"]
    loss = {"card": float(m_d["loss"]), "cpu": float(m_c["loss"])}
    norms = {"card": float(n_d), "cpu": float(n_c)}
    grad_err = _scaled_err(torch, tree_leaves(g_d), tree_leaves(g_c))
    # AdamW on identical inputs: the card's gradients, in both places
    init, update = make_optimizer("adamw", warmup=TRAIN_WARMUP,
                                  total_steps=TRAIN_STEPS)
    upd = {}
    for where, p in (("card", p_d), ("cpu", p_c)):
        before = [t.clone() for t in tree_leaves(p)]
        grads = tree_map(lambda t, d=p["final_norm"].device: t.to(
            d, copy=True), g_d)
        state = init(p)
        with torch.no_grad():
            update(grads, state, p)
        upd[where] = ([a - b for a, b in zip(tree_leaves(p), before)],
                      tree_leaves(state["m"]) + tree_leaves(state["v"]))
        del before, grads
    update_err = _scaled_err(torch, upd["card"][0], upd["cpu"][0])
    state_err = _scaled_err(torch, upd["card"][1], upd["cpu"][1])
    params_err = _scaled_err(torch, tree_leaves(p_d), tree_leaves(p_c))
    rel = {"loss": abs(loss["card"] - loss["cpu"]) / abs(loss["cpu"]),
           "grad_norm": abs(norms["card"] - norms["cpu"]) / norms["cpu"]}
    emit(phase="train_parity", model=TRAIN_MODEL,
         config=dict(n_layers=cfg.n_layers, layers=kinds,
                     d_model=cfg.d_model, heads=cfg.n_heads,
                     kv_heads=cfg.n_kv_heads, head_dim=cfg.resolved_head_dim,
                     d_ff=cfg.d_ff, vocab=cfg.vocab_size,
                     batch=PARITY_BATCH, seq=PARITY_SEQ,
                     plan="remat block, fp32, chunked attention",
                     reduced={"n_layers": [full.n_layers, cfg.n_layers]}),
         params=param_count_actual(params), loss=loss, grad_norm=norms,
         relative_error=rel, grad_max_scaled_err=grad_err,
         adamw_update_max_scaled_err=update_err,
         adamw_state_max_scaled_err=state_err,
         adamw_params_max_scaled_err=params_err,
         grads_seconds=secs, tolerances=TRAIN_TOL, card=smi)
    if not (rel["loss"] <= TRAIN_TOL["loss_rtol"]
            and rel["grad_norm"] <= TRAIN_TOL["grad_norm_rtol"]
            and grad_err <= TRAIN_TOL["grad_scaled"]
            and state_err <= TRAIN_TOL["adamw_state_scaled"]
            and params_err <= TRAIN_TOL["adamw_params_scaled"]):
        raise AssertionError("train parity: the card disagrees with the CPU")
    del out, upd, p_d, g_d, p_c
    return params, batch, g_c


def _train_steps(torch, dev, smi, cfg, plan, steps, tag):
    """gemma2-2b at full width and depth through ``Trainer`` over
    ``Prefetcher(SyntheticLM(...))`` on ``plan``: TRAIN_BATCH x TRAIN_SEQ
    tokens a step, AdamW (warmup TRAIN_WARMUP), ``steps`` steps. Every
    loss finite and the last below the first + 0.05
    (tests/test_system.py's criterion); tokens/s and the median step over
    steps 2 on, the optimizer's share of a step (CUDA events around the
    update), peak memory, a profiled step's idle share and the six
    kernels' launches (none: the reference's training path runs no Pallas
    kernel, and the kernels refuse grad). Returns the figures."""
    import numpy as np
    from repro_torch.data.pipeline import Prefetcher, SyntheticLM
    from repro_torch.models.model import param_count_actual
    from repro_torch.training import train_step as TS
    from repro_torch.training.trainer import Trainer
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated(dev)
    if held >= FAMILY_HELD_BYTES:
        raise AssertionError(f"{tag}: {held} bytes still allocated before "
                             "the phase")
    torch.cuda.reset_peak_memory_stats()
    mods = _kernel_modules()
    for mod in mods:
        mod.reset_counts()
    events = []
    inner = TS.make_optimizer

    def timed(name, **kw):
        init, update = inner(name, **kw)

        def upd(grads, state, params):
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            res = update(grads, state, params)
            b.record()
            events.append((a, b))
            return res
        return init, upd
    data = Prefetcher(SyntheticLM(cfg.vocab_size, TRAIN_BATCH, TRAIN_SEQ,
                                  seed=SEED), depth=2)
    t0 = time.perf_counter()
    TS.make_optimizer = timed
    try:
        tr = Trainer(cfg, plan, data, device=dev, seed=SEED,
                     total_steps=steps, warmup=TRAIN_WARMUP)
    finally:
        TS.make_optimizer = inner
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = param_count_actual(tr.params)
    hist = tr.run(steps)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev)
    launches = {k: v for mod in mods for k, v in mod.LAUNCHES.items()}
    plain = {k: v for mod in mods for k, v in mod.PLAIN_CALLS.items()}
    opt_ms = [a.elapsed_time(b) for a, b in events]
    losses = [h["loss"] for h in hist]
    step_s = float(np.median([h["step_time_s"] for h in hist[1:]]))
    opt_med = float(np.median(opt_ms[1:]))
    tokens = TRAIN_BATCH * TRAIN_SEQ
    prof = _profiled(torch, tag, lambda: tr.run(1), smi)
    data.close()
    opt_bytes = 7 * 4 * n_params      # p, m, v read and written; g read
    flops = 6.0 * n_params * tokens
    out = dict(
        params=n_params, init_seconds=init_s, losses=losses,
        grad_norms=[h["grad_norm"] for h in hist],
        step_seconds=[h["step_time_s"] for h in hist],
        median_step_s_steps_2_on=step_s, tokens_per_s=tokens / step_s,
        optimizer_ms=opt_ms, optimizer_median_ms=opt_med,
        optimizer_share=opt_med / 1e3 / step_s,
        optimizer_bound_ms=opt_bytes / HBM_BYTES_PER_S * 1e3,
        model_flops_per_step=flops,
        model_flops_share_fp32=flops / (step_s * FP32_FLOPS_PER_S),
        model_flops_share_bf16=flops / (step_s * BF16_FLOPS_PER_S),
        profiled_step_idle_share=prof["device_idle_share"],
        max_memory_allocated=peak, memory_allocated_before=held,
        kernel_launches=launches, kernel_plain_calls=plain)
    if not all(math.isfinite(x) for x in losses) or \
            not losses[-1] < losses[0] + 0.05:
        raise AssertionError(f"{tag}: losses {losses}")
    if any(launches.values()):
        raise AssertionError(f"{tag}: kernel launches {launches}")
    del tr
    return out


def phase_train(torch, dev, smi):
    """Phase 25: ``_train_steps`` on the launch plan (remat by block, fp32,
    logits in chunks of TRAIN_CHUNK), TRAIN_STEPS steps. Returns the
    figures (phase 25b prints its own beside them)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ExecutionPlan
    cfg = get_config(TRAIN_MODEL)
    plan = ExecutionPlan(remat="block", compute_dtype="float32",
                         logits_chunk=TRAIN_CHUNK)
    out = _train_steps(torch, dev, smi, cfg, plan, TRAIN_STEPS, "train_step")
    emit(phase="train", model=TRAIN_MODEL,
         config=dict(n_layers=cfg.n_layers, d_model=cfg.d_model,
                     vocab=cfg.vocab_size, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                     steps=TRAIN_STEPS, warmup=TRAIN_WARMUP,
                     logits_chunk=TRAIN_CHUNK, optimizer="adamw",
                     plan="remat block, fp32, chunked attention"),
         **out,
         kernel_launches_why=("none: the reference's training path runs no "
                              "Pallas kernel (chunked attention, XLA "
                              "code), so the port's trains on plain "
                              "autograd; the kernels refuse grad"),
         card=smi)
    return out


def phase_train_bf16(torch, dev, smi, fp32):
    """Phase 25b: gemma2-2b on its own train plan, ``default_plan(cfg,
    ShapeSpec("train", TRAIN_SEQ, TRAIN_BATCH, "train"), n_chips=1)``:
    TRAIN_BATCH microbatches of one sequence, remat by block, AdamW on fp32
    params, bf16 compute, logits in chunks of 1024 (one chunk at
    TRAIN_SEQ), TRAIN16_STEPS steps through ``_train_steps`` (its checks);
    the model-flops share of the bf16 peak beside phase 25's fp32 figures
    (``fp32``) from the same call."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec, default_plan
    cfg = get_config(TRAIN_MODEL)
    plan = default_plan(cfg, ShapeSpec("train", TRAIN_SEQ, TRAIN_BATCH,
                                       "train"), n_chips=1)
    if plan.compute_dtype != "bfloat16" or plan.param_dtype != "float32":
        raise AssertionError(f"train_bf16: the default plan is {plan}")
    out = _train_steps(torch, dev, smi, cfg, plan, TRAIN16_STEPS,
                       "train_step_bf16")
    keys = ("median_step_s_steps_2_on", "tokens_per_s",
            "optimizer_median_ms", "optimizer_share",
            "model_flops_share_fp32", "model_flops_share_bf16",
            "profiled_step_idle_share", "max_memory_allocated")
    emit(phase="train_bf16", model=TRAIN_MODEL,
         config=dict(n_layers=cfg.n_layers, d_model=cfg.d_model,
                     vocab=cfg.vocab_size, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                     steps=TRAIN16_STEPS, warmup=TRAIN_WARMUP,
                     plan={k: v for k, v in dataclasses.asdict(plan).items()
                           if k in ("microbatches", "remat", "optimizer",
                                    "param_dtype", "compute_dtype",
                                    "logits_chunk", "attn_impl")}),
         **out, fp32_beside={k: fp32[k] for k in keys},
         step_ratio_fp32_over_bf16=(fp32["median_step_s_steps_2_on"]
                                    / out["median_step_s_steps_2_on"]),
         card=smi)
    return out


def phase_train_parity_bf16(torch, dev, smi, params, batch, g32):
    """Phase 24b: phase 24's cut (gemma2-2b at full width, PARITY_LAYERS
    layers) on gemma2-2b's bf16 train plan (remat by block, bf16 compute
    over fp32 params, chunked attention): one step's gradients on the card
    and on the CPU from phase 24's params and batch. bf16 rounds each
    op's result; the card's GEMMs sum in other orders than the CPU's, so
    their roundings differ. The card is held to a yardstick, the CPU's
    own bf16 error: per parameter leaf, ``||card16 - cpu32||`` (Frobenius)
    at most TRAIN16_FACTOR x ``||cpu16 - cpu32||``, where ``cpu32`` is
    phase 24's CPU gradients (``g32``); the losses within
    TRAIN16_LOSS_RTOL. Both enforced and printed, with the plain scaled
    error of card against CPU in bf16."""
    import dataclasses

    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ExecutionPlan
    from repro_torch.models.model import tree_leaves, tree_map
    from repro_torch.training.train_step import grads_of
    cfg = dataclasses.replace(get_config(TRAIN_MODEL),
                              n_layers=PARITY_LAYERS)
    plan = ExecutionPlan(remat="block", compute_dtype="bfloat16",
                         param_dtype="float32", logits_chunk=0)
    out, secs = {}, {}
    for where, d in (("card", dev), ("cpu", torch.device("cpu"))):
        p = tree_map(lambda t, d=d: t.to(d, copy=True), params)
        b = {k: v.to(d) for k, v in batch.items()}
        t0 = time.perf_counter()
        g, m = grads_of(p, b, cfg, plan)
        float(m["loss"])
        secs[where] = time.perf_counter() - t0
        out[where] = ([t.cpu() for t in tree_leaves(g)], float(m["loss"]))
        del p, g
    (g_d, loss_d), (g_c, loss_c) = out["card"], out["cpu"]
    ratios, worst = [], 0.0
    for a, b, ref in zip(g_d, g_c, tree_leaves(g32)):
        err = float((a - ref).norm())
        yard = float((b - ref).norm())
        ratios.append(err / yard if yard else (0.0 if err == 0 else
                                               math.inf))
    grad16_err = _scaled_err(torch, g_d, g_c)
    rel = abs(loss_d - loss_c) / abs(loss_c)
    emit(phase="train_parity_bf16", model=TRAIN_MODEL,
         config=dict(n_layers=cfg.n_layers, batch=PARITY_BATCH,
                     seq=PARITY_SEQ, plan="remat block, bf16 compute, fp32 "
                     "params, chunked attention"),
         loss={"card": loss_d, "cpu": loss_c}, loss_relative_error=rel,
         yardstick_ratio_max=max(ratios),
         yardstick_ratio_median=float(np.median(ratios)),
         yardstick_ratios=ratios, grad_max_scaled_err_card_vs_cpu=grad16_err,
         grads_seconds=secs, tolerances=dict(
             loss_rtol=TRAIN16_LOSS_RTOL, yardstick_factor=TRAIN16_FACTOR),
         card=smi)
    if not (rel <= TRAIN16_LOSS_RTOL and max(ratios) <= TRAIN16_FACTOR):
        raise AssertionError("train parity bf16: the card strays from the "
                             "CPU's fp32 gradients more than the CPU's bf16")
    del out, g_d, g_c


def _bit_equal(torch, a, b) -> bool:
    from repro_torch.models.model import tree_leaves
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and x.shape == y.shape
        and torch.equal(x, y.to(x.device)) for x, y in zip(la, lb))


def phase_checkpoint(torch, dev, smi, parity_params, keep):
    """Phase 26: (a) a ``Trainer`` at CKPT_WIDTH (its params and AdamW
    state fit the trainer's 256 MB store) checkpoints every CKPT_EVERY
    steps to two replicas; a fresh ``Trainer`` resumes at the same step,
    params and state bit-equal; ``fail(1)``, ``rebuild(1)`` through
    ``stream_store``, then replica 1 alone restores bit-equal; the restored
    params serve through ``ServeEngine`` (``fused``) the live params'
    tokens and logits. (b) phase 24's params through a
    ``ReplicatedCheckpoint`` sized for them: save, restore (bit-equal) and
    rebuild (every byte streamed; (a) restores a rebuilt replica), seconds
    and MB/s, the bytes needed and the disk's free space first. (c) ``python -m
    repro_torch.launch.train --arch gemma2-2b --steps 3 --ckpt-dir`` in a
    subprocess, exit 0. Files under ``keep`` (in TMPDIR): (b)'s two
    replicas stay for phase 27, the rest is removed. Returns (b)'s
    checkpoint: its directories, bytes, capacity and the params' keys."""
    import dataclasses

    import numpy as np
    from repro_torch.checkpoint import ReplicatedCheckpoint
    from repro_torch.checkpoint.store import BS
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ExecutionPlan
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models.model import param_count_actual
    from repro_torch.serving.engine import GenRequest, ServeEngine
    from repro_torch.models.model import tree_leaves, tree_map
    from repro_torch.training.trainer import CKPT_CAPACITY, Trainer
    tmp = os.path.join(keep, "phase26")
    os.makedirs(tmp)
    try:
        # (a) resume, rebuild, serve at a width the trainer's store holds
        cfg = dataclasses.replace(get_config(TRAIN_MODEL),
                                  name=f"{TRAIN_MODEL}-ckpt", **CKPT_WIDTH)
        plan = ExecutionPlan(remat="block", compute_dtype="float32",
                             logits_chunk=0)
        dirs = [os.path.join(tmp, d) for d in "ab"]
        kw = dict(ckpt_dirs=dirs, ckpt_every=CKPT_EVERY, device=dev,
                  seed=SEED, total_steps=10, warmup=2)
        tr = Trainer(cfg, plan, SyntheticLM(cfg.vocab_size, 4, 64), **kw)
        hist = tr.run(CKPT_STEPS)
        tr.ckpt.close()
        t0 = time.perf_counter()
        tr2 = Trainer(cfg, plan, None, **kw)
        resume_s = time.perf_counter() - t0
        resumed = (tr2.step == tr.step and _bit_equal(torch, tr2.params,
                                                      tr.params)
                   and _bit_equal(torch, tr2.opt_state, tr.opt_state))
        rc = tr2.ckpt
        rc.fail(1)
        t0 = time.perf_counter()
        info = rc.rebuild(1)
        rebuild_s = time.perf_counter() - t0
        step, blob = rc.stores[1].restore("train", like=tr2._state(),
                                          device=dev)
        rebuilt = (step == tr.step
                   and _bit_equal(torch, blob["params"], tr.params)
                   and _bit_equal(torch, blob["opt"], tr.opt_state))
        rc.close()
        served, logits = {}, {}
        prompt = np.random.default_rng(SEED).integers(0, cfg.vocab_size, 16)
        for name, p in (("live", tr.params), ("restored", blob["params"])):
            eng = ServeEngine(cfg, p, n_slots=2, max_len=128, device=dev,
                              kernel="cuda", record_logits=True)
            req = GenRequest(req_id=0, prompt=prompt, max_new=8)
            eng.submit(req)
            served[name] = eng.run(max_steps=32)[0]
            logits[name] = np.stack(req.logit_trace)
            eng.volumes.close()
            del eng
        logit_diff = float(np.abs(logits["live"] - logits["restored"]).max())
        small = dict(params=param_count_actual(tr.params),
                     version_bytes=sum(t.numel() * t.element_size()
                                       for t in tree_leaves(tr._state())),
                     store_bytes=tr.ckpt.capacity, losses=[h["loss"]
                                                        for h in hist],
                     resumed_step=tr2.step, resume_s=resume_s,
                     resume_bit_equal=resumed, rebuild=info,
                     rebuild_s=rebuild_s, rebuilt_restore_bit_equal=rebuilt,
                     served_tokens=served, served_logit_max_diff=logit_diff,
                     served_equal=(served["live"] == served["restored"]
                                   and logit_diff == 0.0))
        del tr, tr2, blob
        gc.collect()
        torch.cuda.empty_cache()

        # (b) phase 24's params through a store sized for them, the
        # embedding table (2.36 of their 2.98 GB) left out for the
        # script's time (CKPT_LEAVE_OUT)
        tree = tree_map(lambda t: t.to(dev), {
            k: v for k, v in parity_params.items()
            if k not in CKPT_LEAVE_OUT})
        leaves = tree_leaves(tree)
        need = sum(-(-t.numel() * t.element_size() // BS) * BS
                   for t in leaves) + 16 * BS
        disk = shutil.disk_usage(tmp)
        # two replicas and one rebuilt, then (c)'s two stores beside them
        room = disk.free - 2 * CKPT_CAPACITY
        reduced = {"leaves": [sorted(parity_params), sorted(tree)],
                   "why": "the embedding table left out for the script's "
                          "time"}
        if 3 * need > room:
            kept_leaves, size = [], 0
            for name in sorted(tree):
                n = sum(t.numel() * 4 for t in tree_leaves(tree[name]))
                if 3 * (size + n + 16 * BS) <= room:
                    kept_leaves.append(name)
                    size += n
            reduced = {"leaves": [sorted(tree), kept_leaves]}
            tree = {k: tree[k] for k in kept_leaves}
            need = size + 16 * BS
        big = [os.path.join(keep, f"big_{d}") for d in "ab"]
        rc = ReplicatedCheckpoint(big, capacity_bytes=int(need * 1.05))
        mb = need / 2**20
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rc.save("parity", 24, tree)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        step, back = rc.restore("parity", like=tree, device=dev)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        restored = step == 24 and _bit_equal(torch, back, tree)
        del back
        rc.fail(1)
        t0 = time.perf_counter()
        binfo = rc.rebuild(1)
        brebuild_s = time.perf_counter() - t0
        brebuilt = binfo["counters"]["bytes_moved"] >= need - 16 * BS
        rc.close()
        saved = dict(dirs=big, need=need, capacity=int(need * 1.05),
                     keys=sorted(tree))
        del tree, leaves
        large = dict(bytes_needed=need, disk_free=disk.free,
                     disk_total=disk.total, fs=fs_of(tmp), reduced=reduced,
                     save_s=save_s, save_mb_per_s=2 * mb / save_s,
                     restore_s=restore_s, restore_mb_per_s=mb / restore_s,
                     rebuild_s=brebuild_s, rebuild_mb_per_s=mb / brebuild_s,
                     rebuild=binfo["counters"], restore_bit_equal=restored,
                     rebuild_streamed_every_byte=brebuilt)

        # (c) the launcher as a user runs it
        t0 = time.perf_counter()
        cp = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.train", "--arch",
             TRAIN_MODEL, "--steps", "3", "--ckpt-dir",
             os.path.join(tmp, "launch")], capture_output=True, text=True,
            timeout=600, cwd=ROOT,
            env=dict(os.environ, PYTHONPATH=str(SRC)))
        launch = dict(rc=cp.returncode, seconds=time.perf_counter() - t0,
                      stdout=cp.stdout.strip().splitlines()[-3:],
                      stderr=cp.stderr.strip().splitlines()[-3:])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit(phase="checkpoint", trainer=small, parity_params=large,
         launch=launch, card=smi)
    if not (resumed and rebuilt and small["served_equal"] and restored
            and brebuilt and launch["rc"] == 0):
        raise AssertionError("checkpoint phase failed (see its line)")
    return saved



def phase_distributed(torch, dev, smi, parity_params, saved, keep):
    """Phase 27: the mesh on one card, a (1, 1) ("data", "model") NCCL mesh
    (a 1-rank group on a localhost rendezvous, destroyed at the end). (a) ``machine_profile()``
    names the card without assuming. (b) The planner's placements for every
    parameter leaf of gemma2-2b at its published widths and depth, the
    params placed as DTensors. (c) One decode step of phase 24's cut after
    a DIST_BATCH x DIST_PROMPT prefill through ``decode_step(...,
    paged_decode_fn=make_sharded_paged_decode(mesh, True))`` against the
    same step through the local paged read: equal tokens, logits within
    DIST_TOL; the striped read of the first paged layer held against the
    paged kernel (``paged_attention_fwd``) on the same pools and block
    table, within ATTN_TOL. (d) Phase 26's checkpoint restored through
    ``ReplicatedCheckpoint.restore(..., mesh=, placements=)`` with the
    planner's placements: every leaf bit-equal, MB/s. (e)
    ``compressed_cross_pod_mean`` (two steps, error feedback) and
    ``hierarchical_psum`` on a (1, 1, 1) ("pod", "data", "model") mesh
    and the (1, 1) one: on one rank each is exact. Returns the paged
    kernel's check calls."""
    import dataclasses

    import torch.distributed as dist
    from repro_torch.checkpoint import ReplicatedCheckpoint
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ExecutionPlan
    from repro_torch.distributed.collectives import (
        compress_int8, compressed_cross_pod_mean, decompress_int8,
        hierarchical_psum, make_sharded_paged_decode)
    from repro_torch.distributed.planner import Planner, distribute
    from repro_torch.kernels.paged_attention import kernel as paged_mod
    from repro_torch.launch.mesh import local_init_method, make_mesh
    from repro_torch.models import init_params
    from repro_torch.models.model import (decode_step, default_block_tables,
                                          init_cache, leaves_up_to,
                                          param_count_actual, prefill,
                                          tree_leaves, tree_map,
                                          with_block_tables)
    from repro_torch.utils.machine import machine_profile
    t_phase = time.perf_counter()
    dist.init_process_group("nccl", init_method=local_init_method(),
                            world_size=1, rank=0)
    try:
        mesh = make_mesh((1, 1), ("data", "model"), "cuda")
        prof = machine_profile()
        profile = dict(prof.to_dict(), device=torch.cuda.get_device_name(0))

        # (b) the planner over gemma2-2b at its published shapes
        full = get_config(TRAIN_MODEL)
        plan = ExecutionPlan(compute_dtype="float32")
        t0 = time.perf_counter()
        params = init_params(torch.Generator(device=dev).manual_seed(SEED),
                             full)
        planner = Planner(mesh, full, plan)
        places = planner.shardings(params)
        placed = distribute(params, mesh, places, src_data_rank=None)
        got = tree_leaves(placed)
        places = leaves_up_to(params, places)
        planned = dict(
            leaves=len(places), params=param_count_actual(params),
            dtensors=sum(type(t).__name__ == "DTensor" for t in got),
            sharded_leaves=sum(any(x.is_shard() for x in pl)
                               for pl in places),
            equal=all(torch.equal(a.to_local(), b)
                      for a, b in zip(got, tree_leaves(params))),
            seconds=time.perf_counter() - t0)
        del params, placed, got, places
        gc.collect()
        torch.cuda.empty_cache()

        # (c) the striped decode against the local paged read and kernel #4
        cfg = dataclasses.replace(full, n_layers=PARITY_LAYERS)
        p = tree_map(lambda t: t.to(dev), parity_params)
        rng = torch.Generator().manual_seed(SEED + 27)
        tokens = torch.randint(0, cfg.vocab_size, (DIST_BATCH, DIST_PROMPT),
                               generator=rng).to(dev)
        caches = init_cache(cfg, DIST_BATCH, DIST_MAX_LEN,
                            dtype=torch.float32, device=dev)
        caches = with_block_tables(caches, default_block_tables(
            cfg, DIST_BATCH, DIST_MAX_LEN, device=dev))
        with torch.no_grad():
            logits0, caches = prefill(p, tokens, cfg, plan, caches)
        nxt = logits0.argmax(-1)
        pos = torch.full((DIST_BATCH,), DIST_PROMPT, dtype=torch.int32,
                         device=dev)
        striped = make_sharded_paged_decode(mesh, True)
        calls = []

        def recorded(q, k_new, v_new, pool_k, pool_v, table, q_pos, **kw):
            out, pk, pv = striped(q, k_new, v_new, pool_k, pool_v, table,
                                  q_pos, **kw)
            if not calls:
                calls.append((q, pk.clone(), pv.clone(), table, q_pos, kw,
                              out))
            return out, pk, pv
        logits = {}
        paged_mod.reset_counts()
        for name, fn in (("striped", recorded), ("local", None)):
            c = tree_map(lambda t: t.clone(), caches)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with torch.no_grad():
                logits[name], _ = decode_step(p, nxt, pos, cfg, plan, c,
                                              paged_decode_fn=fn)
            torch.cuda.synchronize()
            logits[name + "_s"] = time.perf_counter() - t0
            del c
        step_launches = dict(paged_mod.LAUNCHES)
        diff = float((logits["striped"] - logits["local"]).abs().max())
        logits_ok = torch.allclose(logits["striped"], logits["local"],
                                   **DIST_TOL)
        tokens_equal = torch.equal(logits["striped"].argmax(-1),
                                   logits["local"].argmax(-1))
        q, pk, pv, table, q_pos, kw, out = calls[0]
        want = paged_mod.paged_attention_fwd(
            q[:, 0].contiguous(), pk, pv, table, q_pos[:, 0] + 1,
            window=kw["window"], logit_cap=kw["logit_cap"],
            scale=kw["scale"])
        check_calls = paged_mod.LAUNCHES["paged_attention"] - \
            step_launches["paged_attention"]
        kernel_err = float((out[:, 0].float() - want).abs().max())
        kernel_ok = torch.allclose(out[:, 0].float(), want, **ATTN_TOL)
        decode = dict(
            layers=[cfg.layer_kind(i) for i in range(cfg.n_layers)],
            batch=DIST_BATCH, prompt=DIST_PROMPT, max_len=DIST_MAX_LEN,
            stride=striped.stride, owner_rank=striped.owner_rank,
            logits_max_abs_diff=diff, logits_within_tol=logits_ok,
            tokens_equal=tokens_equal, tolerance=DIST_TOL,
            seconds={k[:-2]: v for k, v in logits.items()
                     if k.endswith("_s")},
            paged_launches_in_the_two_steps=step_launches["paged_attention"],
            kernel_check=dict(pool_shape=list(pk.shape),
                              table_shape=list(table.shape),
                              max_abs_err=kernel_err, within_tol=kernel_ok,
                              calls=check_calls, tolerance=ATTN_TOL))
        del calls, q, pk, pv, out, want, caches, logits

        # (d) phase 26's checkpoint restored onto the mesh
        tree = {k: p[k] for k in saved["keys"]}
        cplan = Planner(mesh, cfg, plan)
        rc = ReplicatedCheckpoint(saved["dirs"],
                                  capacity_bytes=saved["capacity"],
                                  mesh=mesh)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step, back = rc.restore("parity", like=tree, mesh=mesh,
                                placements=cplan.shardings(tree))
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        rc.close()
        got, want = tree_leaves(back), tree_leaves(tree)
        restore = dict(
            step=step, leaves=len(got), bytes=saved["need"],
            dtensors=sum(type(t).__name__ == "DTensor" for t in got),
            bit_equal=len(got) == len(want) and all(
                a.to_local().dtype == b.dtype and torch.equal(a.to_local(),
                                                              b)
                for a, b in zip(got, want)),
            seconds=restore_s, mb_per_s=saved["need"] / 2**20 / restore_s,
            fs=fs_of(keep))
        del back, got, want, tree, p

        # (e) the gradient collectives on one rank
        mesh3 = make_mesh((1, 1, 1), ("pod", "data", "model"), "cuda")
        gen = torch.Generator(device=dev).manual_seed(SEED + 28)
        grads = [{"w": torch.randn((2304, 2304), generator=gen, device=dev),
                  "b": torch.randn((2304,), generator=gen, device=dev) * 1e-3}
                 for _ in range(2)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m0, ef = compressed_cross_pod_mean(grads[0], mesh3)
        m1, ef1 = compressed_cross_pod_mean(grads[1], mesh3,
                                            error_feedback=ef)
        torch.cuda.synchronize()
        mean_s = time.perf_counter() - t0
        exact = True
        for k in ("w", "b"):
            a0 = decompress_int8(*compress_int8(grads[0][k]))
            g1 = grads[1][k] + (grads[0][k] - a0)
            a1 = decompress_int8(*compress_int8(g1))
            exact &= (torch.equal(m0[k], a0) and torch.equal(ef[k],
                                                             grads[0][k] - a0)
                      and torch.equal(m1[k], a1)
                      and torch.equal(ef1[k], g1 - a1))
        x = grads[0]["w"]
        psum_exact = (torch.equal(hierarchical_psum(x, mesh3), x)
                      and torch.equal(hierarchical_psum(x, mesh), x))
        collectives = dict(compressed_mean_exact=bool(exact),
                           hierarchical_psum_exact=psum_exact,
                           two_steps_ms=mean_s * 1e3,
                           elements=sum(t.numel() for t in grads[0].values()))
        del grads, m0, m1, ef, ef1, x
    finally:
        dist.destroy_process_group()
    seconds = time.perf_counter() - t_phase
    emit(phase="distributed", mesh={"data": 1, "model": 1},
         backend="nccl", profile=profile, planner=planned, decode=decode,
         restore=restore, collectives=collectives, seconds=seconds,
         card=smi)
    ok = (not prof.assumed and prof.name.startswith("h100")
          and planned["dtensors"] == planned["leaves"] and planned["equal"]
          and logits_ok and tokens_equal and kernel_ok and check_calls >= 1
          and restore["bit_equal"] and restore["step"] == 24
          and restore["dtensors"] == restore["leaves"]
          and collectives["compressed_mean_exact"]
          and collectives["hierarchical_psum_exact"])
    if not ok:
        raise AssertionError("distributed phase failed (see its line)")
    return check_calls

# ---------------------------------------------------------------------------
# phase 28: the dry run
# ---------------------------------------------------------------------------
def start_dryruns(out_dir: str) -> dict:
    """Phase 28's fake-world counts, each ``python -m
    repro_torch.launch.dryrun`` in a process of its own, started now and
    left running: ``{name: (Popen, record path)}``."""
    # on the CPU only: no CUDA context beside (c)'s launcher (the
    # records' peaks are then the H100 data sheet's, "assumed")
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1",
               CUDA_VISIBLE_DEVICES="")
    base = [sys.executable, "-m", "repro_torch.launch.dryrun"]
    cmds = {f"{a}:{sh}": ["--arch", a, "--shape", sh] for a, sh in DRY_CELLS}
    real = ["--arch", DRY_MODEL, "--shape", "decode_32k", "--mesh", "1,1",
            "--global-batch", str(DRY_BATCH)]
    cmds["real_cell"] = real + [a for k, v in DRY_PLAN.items()
                                for a in ("--plan", f"{k}={v}")]
    cmds["real_cell_bf16"] = real          # the cell's own serve plan
    runs = {}
    for i, (name, args) in enumerate(cmds.items()):
        path = os.path.join(out_dir, f"cell{i}.json")
        runs[name] = (subprocess.Popen(
            base + args + ["--out", path], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True, cwd=ROOT, env=env), path)
    return runs


def stop_dryruns(runs: dict) -> None:
    for proc, _ in runs.values():
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def _dry_record(proc, path) -> dict:
    out, _ = proc.communicate(timeout=DRY_TIMEOUT)
    if proc.returncode != 0:
        raise AssertionError(f"dryrun exited {proc.returncode}:\n"
                             f"{out[-3000:]}")
    with open(path) as f:
        rec = json.load(f)[0]
    if rec.get("status") != "ok":
        raise AssertionError(f"dryrun cell failed: {rec}")
    return rec


DRY_KEYS = ("arch", "shape", "mesh", "kind", "global_batch", "plan",
            "count_s", "flops_per_device", "bytes_per_device",
            "collective_bytes_per_device", "collectives", "ops",
            "model_flops_total", "hlo_useful_ratio", "t_compute", "t_memory",
            "t_collective", "bottleneck", "roofline_fraction",
            "analytic_state_bytes_per_device", "peak")


def _entry_host_us(torch, cell, cfg, dev, build, n=200):
    """Host microseconds a call of the paged entry takes at the cell's
    first paged layer (its pools and table, every position live), direct
    and through its custom op, in turns; no synchronisation inside a run,
    so the card's work overlaps and only the host's is timed."""
    from repro_torch.kernels.paged_attention.kernel import (
        paged_attention_lse_fwd)
    c = next(c for c in cell.args[3] if c is not None and "pool_k" in c)
    pk, pv = c["pool_k"].to_local(), c["pool_v"].to_local()
    table = c["block_table"].to_local()
    b = table.shape[0]
    gen = torch.Generator(device=dev).manual_seed(SEED + 29)
    q = torch.randn((b, cfg.n_heads, cfg.resolved_head_dim), generator=gen,
                    device=dev)
    lengths = torch.full((b,), table.shape[1] * pk.shape[1],
                         dtype=torch.int32, device=dev)
    direct = build.dispatching
    us = {"direct": [], "custom_op": []}
    for _round in range(4):
        for route in us:
            build.dispatching = direct if route == "direct" else \
                (lambda: True)
            try:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(n // 4):
                    paged_attention_lse_fwd(q, pk, pv, table, lengths)
                us[route].append((time.perf_counter() - t0) / (n // 4) * 1e6)
                torch.cuda.synchronize()
            finally:
                build.dispatching = direct
    return {k: sorted(v)[len(v) // 2] for k, v in us.items()}


def _lse_check(torch, cell, cfg, dev) -> dict:
    """The stripe entry ``paged_attention_lse_fwd`` at the cell's first
    paged layer's shapes, on its pools (refilled with random rows: the
    cell's are zeros but for the step's one position), its table and the
    model's logit cap, q random and the lengths from every position live
    down to one: out against ``paged_attention_ref(..., return_lse=True)``
    within ATTN_TOL, the log-sum-exp within DRY_LSE_TOL. Run after the
    timed steps (the refill ends the cell's use)."""
    from repro_torch.kernels.paged_attention.kernel import (
        paged_attention_lse_fwd)
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref
    c = next(c for c in cell.args[3] if c is not None and "pool_k" in c)
    pk, pv = c["pool_k"].to_local(), c["pool_v"].to_local()
    table = c["block_table"].to_local()
    b = table.shape[0]
    full = table.shape[1] * pk.shape[1]
    gen = torch.Generator(device=dev).manual_seed(SEED + 30)
    pk.normal_(generator=gen)
    pv.normal_(generator=gen)
    q = torch.randn((b, cfg.n_heads, pk.shape[-1]), generator=gen, device=dev)
    lengths = torch.randint(1, full + 1, (b,), generator=gen, device=dev,
                            dtype=torch.int32)
    lengths[0], lengths[-1] = full, 1
    kw = dict(logit_cap=cfg.attn_logit_softcap)
    out, lse = paged_attention_lse_fwd(q, pk, pv, table, lengths, **kw)
    want_out, want_lse = paged_attention_ref(q, pk, pv, table, lengths,
                                             return_lse=True, **kw)
    err = {"out": float((out - want_out).abs().max()),
           "lse": float((lse - want_lse).abs().max())}
    torch.testing.assert_close(out, want_out, **ATTN_TOL)
    torch.testing.assert_close(lse, want_lse, **DRY_LSE_TOL)
    return {"max_abs_err": err, "lengths": lengths.tolist(),
            "tolerance": {"out": ATTN_TOL, "lse": DRY_LSE_TOL}}


def _real_count(torch, cfg, shape, mesh, plan, paged_mod):
    """One cell built for real on ``mesh`` and its step counted once under
    the counting mode, the paged kernel's counts zeroed just before and read
    just after: (cell, counts, launches, launches by dtype, build s, count
    s, the growth of ``memory_allocated()`` over the build)."""
    from repro_torch.launch.dryrun import count_step
    from repro_torch.launch.specs import build_cell
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    cell = build_cell(cfg, shape, mesh, plan, seed=SEED + 28)
    gc.collect()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    grown = torch.cuda.memory_allocated() - before
    paged_mod.reset_counts()
    t0 = time.perf_counter()
    counts = count_step(cell)
    torch.cuda.synchronize()
    return (cell, counts, dict(paged_mod.LAUNCHES),
            dict(paged_mod.LAUNCHES_BY_DTYPE), build_s,
            time.perf_counter() - t0, grown)


def phase_dryrun(torch, dev, smi, runs, beside=None):
    """Phase 28 (the module docstring): ``runs`` are (a)'s counts
    (``start_dryruns``, started before phase 24), collected first;
    ``beside()`` runs last (phase 29). Returns the paged kernel's launches
    on (b)'s fp32 and bf16 counted steps, and what ``beside`` returned."""
    import dataclasses

    import torch.distributed as dist
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.kernels import _build
    from repro_torch.kernels.paged_attention import kernel as paged_mod
    from repro_torch.launch.dryrun import cell_plan
    from repro_torch.launch.mesh import local_init_method, make_mesh
    from repro_torch.launch.specs import per_device_bytes
    t_phase = time.perf_counter()
    # (a) the production meshes and (b)'s fake counts, on the CPU alone
    # since phase 25: waited for here, so nothing runs beside (b)'s timed
    # steps
    records = {name: _dry_record(*run) for name, run in runs.items()}
    counts_wait_s = time.perf_counter() - t_phase
    # (b) the accounting against the card
    cfg = get_config(DRY_MODEL)
    shape = dataclasses.replace(SHAPES["decode_32k"], global_batch=DRY_BATCH)
    dist.init_process_group("nccl", init_method=local_init_method(),
                            world_size=1, rank=0)
    try:
        mesh = make_mesh((1, 1), ("data", "model"), "cuda")
        plan = cell_plan(cfg, shape, {"data": 1, "model": 1}, DRY_PLAN)
        # the phase's path: one step counted, the paged kernel's counts
        # zeroed just before and read just after
        cell, counts, launches, _by, build_s, count_s, grown = _real_count(
            torch, cfg, shape, mesh, plan, paged_mod)
        analytic = per_device_bytes(mesh, cell.args)
        mem_rel = abs(grown - analytic) / analytic

        def timed(n):
            ms = []
            for _ in range(n):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                logits, _ = cell.step(*cell.args)
                end.record()
                end.synchronize()
                ms.append(start.elapsed_time(end))
            return ms, logits
        direct = _build.dispatching
        timed(2)                                # warm both routes
        _build.dispatching = lambda: True
        try:
            timed(2)
        finally:
            _build.dispatching = direct
        step_ms = {"direct": [], "custom_op": []}
        for _round in range(2):             # in turns: the host drifts
            got, logits = timed(DRY_STEPS // 2)
            step_ms["direct"] += got
            _build.dispatching = lambda: True
            try:
                step_ms["custom_op"] += timed(DRY_OP_STEPS // 2)[0]
            finally:
                _build.dispatching = direct
        local = logits.to_local()
        logits_ok = (tuple(logits.shape) == (DRY_BATCH, cfg.vocab_size)
                     and bool(torch.isfinite(local).all()))
        entry_us = _entry_host_us(torch, cell, cfg, dev, _build)
        lse = _lse_check(torch, cell, cfg, dev)
        del cell, logits, local
        gc.collect()
        torch.cuda.empty_cache()
        # (b') the same cell in its own default serve plan (bf16 params and
        # compute): the kernel entries in their bf16 forms
        plan16 = cell_plan(cfg, shape, {"data": 1, "model": 1})
        cell, counts16, launches16, by16, build16_s, count16_s, grown16 = \
            _real_count(torch, cfg, shape, mesh, plan16, paged_mod)
        logits16 = cell.step(*cell.args)[0]     # the caches go with cell
        local16 = logits16.to_local()
        logits16_ok = (tuple(logits16.shape) == (DRY_BATCH, cfg.vocab_size)
                       and local16.dtype == torch.bfloat16
                       and bool(torch.isfinite(local16.float()).all()))
        del cell, logits16, local16
    finally:
        dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()

    # (c) the serve launcher on the card
    t0 = time.perf_counter()
    cp = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         DRY_MODEL], capture_output=True, text=True, timeout=600,
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(SRC)))
    reqs = [ln for ln in cp.stdout.splitlines() if ln.startswith("req ")]
    serve = dict(rc=cp.returncode, seconds=time.perf_counter() - t0,
                 requests=len(reqs), stdout=reqs,
                 stderr=cp.stderr.strip().splitlines()[-3:])
    t0 = time.perf_counter()
    beside_out = beside() if beside is not None else None
    beside_s = time.perf_counter() - t0
    fake = records.pop("real_cell")
    fake16 = records.pop("real_cell_bf16")
    production = [{k: r[k] for k in DRY_KEYS} for r in records.values()]
    mean = {k: sum(v) / len(v) for k, v in step_ms.items()}
    n_paged = counts["ops"].get("paged_attention_lse", 0)
    real = dict(
        cell=f"{DRY_MODEL}:decode_32k", global_batch=DRY_BATCH,
        cut="global_batch 128 -> %d (about half the card in fp32)"
            % DRY_BATCH, plan=DRY_PLAN, build_s=build_s,
        memory_allocated_growth=grown, per_device_bytes=analytic,
        memory_rel_diff=mem_rel, count_s=count_s,
        flops=counts["flops"], fake_flops=fake["flops_per_device"],
        ops=counts["ops"], fake_ops=fake["ops"],
        bytes=counts["bytes"], fake_bytes=fake["bytes_per_device"],
        launches=launches, step_ms=mean["direct"],
        step_ms_all=step_ms["direct"],
        step_ms_custom_op=mean["custom_op"],
        step_ms_custom_op_all=step_ms["custom_op"],
        custom_op_ms_per_step=mean["custom_op"] - mean["direct"],
        entry_calls_per_step=n_paged, entry_host_us=entry_us,
        custom_op_host_ms_per_step=(entry_us["custom_op"]
                                    - entry_us["direct"]) * n_paged / 1e3,
        t_compute_ms=fake["t_compute"] * 1e3,
        t_memory_ms=fake["t_memory"] * 1e3,
        t_collective_ms=fake["t_collective"] * 1e3,
        bottleneck=fake["bottleneck"], peak=fake["peak"],
        logits_finite=logits_ok, lse_entry=lse)
    n_paged16 = counts16["ops"].get("paged_attention_lse", 0)
    real16 = dict(
        cell=f"{DRY_MODEL}:decode_32k", global_batch=DRY_BATCH,
        plan={"compute_dtype": plan16.compute_dtype,
              "param_dtype": plan16.param_dtype}, build_s=build16_s,
        count_s=count16_s, flops=counts16["flops"],
        fake_flops=fake16["flops_per_device"], ops=counts16["ops"],
        fake_ops=fake16["ops"], bytes=counts16["bytes"],
        fake_bytes=fake16["bytes_per_device"],
        memory_allocated_growth=grown16, launches=launches16,
        launches_by_dtype=by16, entry_calls_per_step=n_paged16,
        t_memory_ms=fake16["t_memory"] * 1e3, logits_finite=logits16_ok)
    emit(phase="dryrun", production=production, real=real, real_bf16=real16,
         serve=serve, counts_wait_s=counts_wait_s, beside_s=beside_s,
         seconds=time.perf_counter() - t_phase - beside_s, card=smi)
    ok = (counts["flops"] == fake["flops_per_device"]
          and counts["ops"] == fake["ops"] and n_paged >= 1
          and launches["paged_attention"] == n_paged
          and counts16["flops"] == fake16["flops_per_device"]
          and counts16["ops"] == fake16["ops"] and n_paged16 >= 1
          and launches16["paged_attention"] == n_paged16
          == by16["bfloat16"] and logits16_ok
          and mem_rel <= DRY_MEM_TOL and logits_ok
          and serve["rc"] == 0 and serve["requests"] == 6)
    if not ok:
        raise AssertionError("dryrun phase failed (see its line)")
    return launches["paged_attention"], launches16["paged_attention"], \
        beside_out


# ---------------------------------------------------------------------------
# phase 29: gemma2-2b on its bf16 serve plan
# ---------------------------------------------------------------------------
def _plan16(attn_impl, dtype="bfloat16"):
    """A 16-bit serve plan's dtypes (params and compute in ``dtype``,
    bfloat16 or float16) on ``attn_impl``: "cuda" for the kernels, "dense"
    for the plain paths (the reference's "chunked" cuts a prompt of prime
    length into one-token chunks)."""
    from repro_torch.configs.base import ExecutionPlan
    return ExecutionPlan(remat="none", attn_impl=attn_impl,
                         compute_dtype=dtype, param_dtype=dtype)


def _lockstep16(torch, dev, cfg, params, prompts, dtype="bfloat16"):
    """BF16_LOCKSTEP's requests on three zero-copy engines with the logits
    recorded: ``dtype`` (bfloat16 or float16, the params') through the
    kernels, ``dtype`` on the plain paths (``attn_impl="dense"``,
    ``kernel="ref"``: every kernel's plain version) and fp32 on the plain
    paths with the same weights upcast (exactly). Every logit of the
    kernel path must be finite. While a request's three token streams
    agree its steps are compared: over them the kernel path's largest
    distance to the fp32 logits must stay within BF16_RATIO of the plain
    16-bit path's. Where the kernel and plain 16-bit tokens differ, the
    plain path's top-2 margin must be under twice that distance (a near
    tie). Returns the line's fields."""
    import numpy as np
    from repro_torch.configs.base import ExecutionPlan
    from repro_torch.models.model import tree_map
    from repro_torch.serving.engine import GenRequest
    n_req, n_new = BF16_LOCKSTEP
    runs = {}
    for name in ("kernel", "plain", "fp32"):
        if name == "fp32":
            p = tree_map(lambda t: t.float() if t.is_floating_point() else t,
                         params)
            plan = ExecutionPlan(remat="none", attn_impl="dense",
                                 compute_dtype="float32")
        else:
            p = params
            plan = _plan16("cuda" if name == "kernel" else "dense", dtype)
        eng = _serve_engine(torch, cfg, p, dev, record_logits=True,
                            plan=plan,
                            kernel="cuda" if name == "kernel" else "ref")
        for rid in range(n_req):
            eng.submit(GenRequest(req_id=rid, prompt=prompts[rid],
                                  max_new=n_new))
        eng.run(max_steps=n_req * n_new)
        runs[name] = {rid: (list(g.out_tokens), np.stack(g.logit_trace))
                      for rid, g in eng.live.items()}
        eng.volumes.close()
        del eng, p
        gc.collect()
        torch.cuda.empty_cache()
    d_kernel = d_plain = d_pair = 0.0
    compared, ties = 0, {}
    for rid in range(n_req):
        (kt, kl), (pt, pl), (ft, fl) = (runs[n][rid]
                                        for n in ("kernel", "plain", "fp32"))
        if not len(kt) == len(pt) == len(ft) == n_new:
            raise AssertionError(f"{dtype} lock step: request {rid} made "
                                 f"{len(kt)}, {len(pt)}, {len(ft)} tokens")
        if not np.isfinite(kl).all():
            raise AssertionError(f"{dtype} lock step: request {rid}'s "
                                 f"logits through the kernels not finite")
        for t in range(n_new):
            d_kernel = max(d_kernel, float(np.abs(kl[t] - fl[t]).max()))
            d_plain = max(d_plain, float(np.abs(pl[t] - fl[t]).max()))
            d_pair = max(d_pair, float(np.abs(kl[t] - pl[t]).max()))
            compared += 1
            if kt[t] != pt[t]:
                ties[rid] = (t, _margin_np(np, pl[t]))
            if kt[t] != pt[t] or pt[t] != ft[t]:
                break
    ok = (compared >= n_req and d_plain > 0
          and d_kernel <= BF16_RATIO * d_plain
          and all(m < 2 * d_plain for _t, m in ties.values()))
    fields = dict(requests=n_req, new_tokens=n_new, steps_compared=compared,
                  kernel_vs_fp32=d_kernel, plain_vs_fp32=d_plain,
                  kernel_vs_plain=d_pair, ratio=BF16_RATIO,
                  near_ties={str(r): v for r, v in ties.items()})
    if not ok:
        raise AssertionError(f"{dtype} lock step failed: {fields}")
    return fields


def _form_parity(torch, kernel, entry, calls, launch, plain, work, rate=None,
                 library=None, lse_tol=None, dtype=None):
    """One 16-bit form on ``calls`` ((args, kw) pairs) against its plain
    version in the working type (``plain`` returns what the wrapper's plain
    version returns: fp32 math rounded to ``dtype``, bf16 by default)
    within ``_attn_tol`` (an lse entry's second output, fp32, within
    ``lse_tol``); timed as in phase
    10 beside the plain version, one PyTorch yardstick (``library(args,
    kw)`` prepares a call's inputs, untimed, and returns the call; None:
    there is none) and the bound: ``work(args, kw)`` -> (flops, bytes),
    flops over ``rate`` (None: bytes alone) against bytes over 3.35 TB/s.
    Emits a kernel_parity line; returns the entry's fields."""
    from repro_torch.kernels.timing import graph_ms
    dtype = dtype or torch.bfloat16
    tol = _attn_tol(torch, dtype)
    err, lse_err, flops, n_bytes = 0.0, 0.0, [], []
    for args, kw in calls:
        got, want = launch(*args, **kw), plain(*args, **kw)
        if lse_tol is not None:
            torch.testing.assert_close(got[1], want[1], **lse_tol)
            lse_err = max(lse_err, float((got[1] - want[1]).abs().max()))
            got, want = got[0], want[0]
        if got.dtype != dtype:
            raise AssertionError(f"{kernel} {entry}: output {got.dtype}")
        torch.testing.assert_close(got.float(), want.float(), **tol)
        err = max(err, float((got.float() - want.float()).abs().max()))
        f, nb = work(args, kw)
        flops.append(f)
        n_bytes.append(nb)
    n = len(calls)
    ms = graph_ms(lambda: [launch(*a, **k) for a, k in calls], n)
    plain_ms = graph_ms(lambda: [plain(*a, **k) for a, k in calls], n)
    lib = None
    if library is not None:
        runs = [library(a, k) for a, k in calls]
        lib = graph_ms(lambda: [run() for run in runs], n)
    f_mean, b_mean = sum(flops) / n, sum(n_bytes) / n
    t_ops = f_mean / rate if rate else 0.0
    t_bytes = b_mean / HBM_BYTES_PER_S
    out = dict(ms=ms, plain_ms=plain_ms, library_ms=lib,
               bound_ms=max(t_ops, t_bytes) * 1e3,
               bound_by="operations" if t_ops >= t_bytes else "bytes",
               max_abs_err=err, calls=n, bytes_per_call=b_mean,
               flops_per_call=f_mean)
    extra = ({"lse_max_abs_err": lse_err, "lse_tolerance": lse_tol}
             if lse_tol is not None else {})
    emit(phase="kernel_parity", kernel=kernel, entry=entry,
         dtype=str(dtype).split(".")[1], tolerance=tol, **out, **extra)
    return out


def _paged_library(torch, q, pk, pv, table, lengths, **kw):
    """The paged yardstick of phase 10, prepared: the index and the
    boolean mask (holes, lengths) made now; the call two ``index_select``
    gathers of the pools' pages, then SDPA with the mask, a KV head's
    query heads on its query axis, in q's dtype (no logit cap: SDPA has
    none)."""
    import torch.nn.functional as F
    b, h, d = q.shape
    _e, page, kv, _ = pk.shape
    p_max = table.shape[1]
    pos = torch.arange(p_max * page, device=q.device)
    mask = ((pos[None, :] < lengths[:, None])
            & (table >= 0).repeat_interleave(page, dim=1))[:, None, None]
    idx = table.clamp(min=0).reshape(-1).long()
    q4 = q.reshape(b, kv, h // kv, d)

    def run():
        kk = pk.index_select(0, idx).reshape(b, p_max * page, kv, -1)
        vv = pv.index_select(0, idx).reshape(b, p_max * page, kv, -1)
        return F.scaled_dot_product_attention(
            q4, kk.transpose(1, 2).to(q.dtype), vv.transpose(1, 2).to(
                q.dtype), attn_mask=mask, scale=kw["scale"])
    return run


def _sdpa(torch, q, k, v, **kw):
    """Phase 10's flash yardstick, prepared: SDPA (causal, GQA, no cap)
    on contiguous copies of q, k and v made now."""
    import torch.nn.functional as F
    q, k, v = (t.contiguous() for t in (q, k, v))
    return lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True, scale=kw["scale"])


def _split_forms16(torch, pool, kept, dtype=None):
    """The split-pool entry and the stripe entry (``paged_attention_lse_fwd``)
    in ``dtype`` (bf16 by default, or fp16) at the serving width: the kept
    decode calls of the 16-bit traffic (q of ``dtype``) over copies in
    ``dtype`` of their layers' K and V planes of the engine pool (E, page,
    KV, hd each; a layer's planes copied once)."""
    from repro_torch.kernels.paged_attention.kernel import (
        paged_attention_fwd, paged_attention_lse_fwd, paged_work)
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref
    dtype = dtype or torch.bfloat16
    tag = _tag16(torch, dtype)
    planes = {}

    def plane(i):
        if i not in planes:
            planes[i] = pool[:, :, i].to(dtype).contiguous()
        return planes[i]
    calls = [((q, plane(kw["k_plane"]), plane(kw["v_plane"]), table,
               lengths), dict(window=kw["window"],
                              logit_cap=kw["logit_cap"], scale=kw["scale"]))
             for q, table, lengths, kw in kept]
    _e, page, kv, d = calls[0][0][1].shape

    def work(args, kw):
        return paged_work(args[0], args[3], args[4], page, kv, d, d,
                          kw["window"], 2)

    def plain(*a, **kw):
        return paged_attention_ref(*a, **kw).to(dtype)

    def plain_lse(*a, **kw):
        out, lse = paged_attention_ref(*a, return_lse=True, **kw)
        return out.to(dtype), lse
    split = _form_parity(torch, "paged_attention", f"split pools, {tag}",
                         calls, paged_attention_fwd, plain, work,
                         library=lambda a, k: _paged_library(torch, *a, **k),
                         dtype=dtype)
    lse = _form_parity(torch, "paged_attention", f"lse (stripe), {tag}",
                       calls, paged_attention_lse_fwd, plain_lse, work,
                       lse_tol=DRY_LSE_TOL, dtype=dtype)
    return split, lse


def _wide_forms16(torch, dev, dtype=None):
    """The wide instantiations' 16-bit forms (``dtype``: bf16 by default,
    or fp16) at deepseek-v3's serving shapes (the absorbed latent: K 576,
    V 512, 128 query heads on one KV head, scale 1/sqrt(192); seeded random
    values): flash on two prompts of BF16_WIDE_PROMPTS tokens in the model
    layout (the mma.sync form); paged on 8 sequences of up to 1024
    positions (page 32, 32 pages, holes past each length, a lane of length
    0) over split pools of ``dtype`` (K 576, V 512) and, q of ``dtype``,
    over an fp32 engine pool of 8 planes at 576 (the packed instantiation,
    each launch checked: its products bound the 16-bit split form at the
    16-bit rate, the fp32 pool's at _packed_rate's: q.K^T in two TF32
    products, P.V in three). Then the narrow mma.sync form at musicgen-
    large's prefill shape (32 heads, d 64, NARROW_MMA_PROMPT tokens) on
    rows one value off 16 bytes (at 16-byte rows d = 64 takes the wgmma
    form)."""
    import numpy as np
    from repro_torch.kernels.flash_attention import (attention_ref,
                                                     flash_attention_fwd)
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention.kernel import flash_work
    from repro_torch.kernels.paged_attention import kernel as pk
    from repro_torch.kernels.paged_attention.kernel import (
        paged_attention_fwd, paged_attention_pool_fwd, paged_work)
    from repro_torch.kernels.paged_attention.ref import (
        paged_attention_pool_ref, paged_attention_ref)
    bf = dtype or torch.bfloat16
    tag = _tag16(torch, bf)
    gen = torch.Generator(device=dev).manual_seed(SEED + 31)
    h, dk, dv, scale = 128, 576, 512, 1.0 / math.sqrt(192.0)
    flash_calls = []
    for s in BF16_WIDE_PROMPTS:
        q = torch.randn((1, s, h, dk), generator=gen, device=dev).to(bf)
        k = torch.randn((1, s, 1, dk), generator=gen, device=dev).to(bf)
        v = torch.randn((1, s, 1, dv), generator=gen, device=dev).to(bf)
        flash_calls.append(((q.transpose(1, 2), k.transpose(1, 2),
                             v.transpose(1, 2)),
                            dict(window=0, logit_cap=0.0, scale=scale)))
    fk.reset_counts()
    wide = {"flash": _form_parity(
        torch, "flash_attention", f"wide (K 576, V 512), {tag}", flash_calls,
        flash_attention_fwd,
        lambda *a, **k: attention_ref(*a, **k).to(bf),
        lambda a, k: flash_work(*a, True, k["window"]), BF16_FLOPS_PER_S,
        library=lambda a, k: _sdpa(torch, *a, **k), dtype=bf)}
    if fk.LAUNCHES_BY_FORM[f"{tag}_mma"] != fk.LAUNCHES["flash_attention"]:
        raise AssertionError(f"the wide {tag} flash form launched "
                             f"{fk.LAUNCHES_BY_FORM}, not {tag}_mma alone")
    b, page, p_max, n_planes = 8, 32, 32, 8
    e = b * p_max + 5
    rng = np.random.default_rng(SEED + 31)
    table = rng.permutation(e - 1)[:b * p_max].reshape(b, p_max) + 1
    lengths = rng.integers(1, p_max * page + 1, b)
    lengths[0], lengths[-1] = 0, p_max * page
    for i in range(b):
        table[i, -(-lengths[i] // page):] = -1
    table = torch.from_numpy(table.astype(np.int32)).to(dev)
    lengths = torch.from_numpy(lengths.astype(np.int32)).to(dev)
    q = torch.randn((b, h, dk), generator=gen, device=dev).to(bf)
    pk_ = torch.randn((e, page, 1, dk), generator=gen, device=dev).to(bf)
    pv = torch.randn((e, page, 1, dv), generator=gen, device=dev).to(bf)
    pool = torch.randn((e, page, n_planes, 1, dk), generator=gen, device=dev)
    kw = dict(window=0, logit_cap=0.0, scale=scale)
    pk.reset_counts()
    wide["paged_split"] = _form_parity(
        torch, "paged_attention", f"wide split pools (576 / 512), {tag}",
        [((q, pk_, pv, table, lengths), kw)], paged_attention_fwd,
        lambda *a, **k: paged_attention_ref(*a, **k).to(bf),
        lambda a, k: paged_work(a[0], a[3], a[4], page, 1, dk, dv, 0, 2),
        BF16_FLOPS_PER_S,
        library=lambda a, k: _paged_library(torch, *a, **k), dtype=bf)
    pkw = dict(kw, k_plane=6, v_plane=7)
    wide["paged_pool"] = _form_parity(
        torch, "paged_attention", f"wide pool (576), {tag} q over fp32",
        [((q, pool, table, lengths), pkw)], paged_attention_pool_fwd,
        lambda *a, **k: paged_attention_pool_ref(*a, **k).to(bf),
        lambda a, k: paged_work(a[0], a[2], a[3], page, 1, dk, dk, 0, 4),
        _packed_rate(torch, bf, torch.float32, dk, dk),
        library=lambda a, k: _paged_library(
            torch, a[0], a[1][:, :, 6], a[1][:, :, 7], a[2], a[3], **k),
        dtype=bf)
    if pk.LAUNCHES_BY_INSTANCE["packed"] != pk.LAUNCHES["paged_attention"]:
        raise AssertionError(f"the wide paged forms launched "
                             f"{pk.LAUNCHES_BY_INSTANCE}, not the packed "
                             f"instantiation alone")
    s, h, d = NARROW_MMA_PROMPT, 32, 64
    q, k, v = (torch.randn((1, s, h, d + 1), generator=gen,
                           device=dev).to(bf)[..., :d].transpose(1, 2)
               for _ in range(3))
    fk.reset_counts()
    wide["flash_narrow_mma"] = _form_parity(
        torch, "flash_attention", f"narrow mma.sync (d 64, rows of 65), "
        f"{tag}", [((q, k, v), dict(window=0, logit_cap=0.0,
                                    scale=1.0 / 8.0))],
        flash_attention_fwd, lambda *a, **k: attention_ref(*a, **k).to(bf),
        lambda a, k: flash_work(*a, True, k["window"]), BF16_FLOPS_PER_S,
        library=lambda a, k: _sdpa(torch, *a, **k), dtype=bf)
    if fk.LAUNCHES_BY_FORM[f"{tag}_mma"] != fk.LAUNCHES["flash_attention"]:
        raise AssertionError(f"the narrow {tag} call launched "
                             f"{fk.LAUNCHES_BY_FORM}, not {tag}_mma alone")
    return wide


def _flash_narrow_f32(torch, dev):
    """Flash's fp32 mma.sync form, which no fp32 path launches since the
    wgmma form took d = dv 64, 128 and 256: one call at musicgen-large's
    prefill shape (32 heads, d 64, NARROW_MMA_PROMPT tokens) on rows of 65
    values (off 16 bytes) against its plain version within ATTN_TOL, timed
    beside its bound (3xTF32's rate) and SDPA on contiguous copies."""
    from repro_torch.kernels.flash_attention import (attention_ref,
                                                     flash_attention_fwd)
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention.kernel import flash_work
    gen = torch.Generator(device=dev).manual_seed(SEED + 33)
    s, h, d = NARROW_MMA_PROMPT, 32, 64
    q, k, v = (torch.randn((1, s, h, d + 1), generator=gen,
                           device=dev)[..., :d].transpose(1, 2)
               for _ in range(3))
    fk.reset_counts()
    got = _form_parity(
        torch, "flash_attention", "narrow mma.sync (d 64, rows of 65), fp32",
        [((q, k, v), dict(window=0, logit_cap=0.0, scale=1.0 / 8.0))],
        flash_attention_fwd, attention_ref,
        lambda a, k: flash_work(*a, True, k["window"]), TF32X3_FLOPS_PER_S,
        library=lambda a, k: _sdpa(torch, *a, **k), dtype=torch.float32)
    if fk.LAUNCHES_BY_FORM["float32"] != fk.LAUNCHES["flash_attention"]:
        raise AssertionError(f"the narrow fp32 call launched "
                             f"{fk.LAUNCHES_BY_FORM}, not float32 alone")
    return dict(got, source=FLASH_SRC, form="float32")


def phase_serve_bf16(torch, dev, smi):
    """Phase 29 (the module docstring). Returns the bf16 forms' fields for
    the kernels line."""
    return _serve16(torch, dev, smi, torch.bfloat16, plain_run=True,
                    n_requests=BF16_REQUESTS)


def phase_serve_f16(torch, dev, smi):
    """Phase 31 (the module docstring): phase 29 on gemma2-2b's fp16 serve
    plan, without its plain 16-request run (c). Returns the fp16 forms'
    fields for the kernels line."""
    return _serve16(torch, dev, smi, torch.float16, plain_run=False,
                    n_requests=SERVE_REQUESTS)


def _serve16(torch, dev, smi, dtype, plain_run, n_requests):
    """Phase 29 or 31: gemma2-2b on its serve plan of the 16-bit ``dtype``
    through the kernels' forms of that dtype, (a)-(d) of the module
    docstring on phase 9's first ``n_requests`` prompts ((c), their plain
    run, with ``plain_run``), then the wide and narrow mma.sync forms at
    kept shapes."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.models.model import tree_map
    t_phase = time.perf_counter()
    name = str(dtype).split(".")[1]
    tag = _tag16(torch, dtype)
    cfg = get_config(SERVE_MODEL)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held_before = torch.cuda.memory_allocated(dev)
    t0 = time.perf_counter()
    params = tree_map(
        lambda t: t.to(dtype) if t.is_floating_point() else t,
        init_params(torch.Generator(device=dev).manual_seed(SEED), cfg))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    lens, prompts = _serve_prompts(np, cfg)
    lens, prompts = lens[:n_requests], prompts[:n_requests]
    # (a) the kernel path: phase 9's traffic and checks on the 16-bit plan
    eng = _serve_engine(torch, cfg, params, dev, plan=_plan16("cuda", name))
    res = _serve_traffic(torch, eng, prompts, _keep_local_global)
    by = res["launches_by_dtype"]
    forms = {"flash_attention": by["flash_attention"][name],
             "paged_attention": by["paged_attention"][f"{name}_q"]}
    if any(forms[k] != res["launches"][k] or forms[k] <= 0 for k in forms):
        raise AssertionError(f"{name} serving launched {by}, not the {tag} "
                             f"forms alone ({res['launches']})")
    by_form = res["launches_by_form"]
    if by_form["flash_attention"][f"{tag}_wgmma"] != \
            res["launches"]["flash_attention"]:
        raise AssertionError(f"{name} prefill launched {by_form}, not the "
                             f"wgmma form alone")
    split, lse = _split_forms16(torch, eng._pools[0], res["kept_paged"],
                                dtype)
    emit(phase="serve_path", model=SERVE_MODEL,
         config=_serve_config(cfg, eng, param_dtype=name),
         **_serve_fields(lens, res), launches_by_dtype=by,
         launches_by_form=by_form, init_seconds=init_s,
         memory_allocated_before=held_before, card=smi)
    rw16 = _rw_forms16(torch, eng, res["kept_read"], res["kept_write"],
                       dtype)
    kernel_tokens = {rid: list(res["outs"][rid]) for rid in res["outs"]}
    eng.volumes.close()
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    # (b) the logits: a lock step against the plain 16-bit and fp32 paths
    lock = _lockstep16(torch, dev, cfg, params, prompts, name)
    if plain_run:
        _plain16_run(torch, dev, smi, cfg, params, prompts, res,
                     kernel_tokens, lock, name)
    else:
        emit(phase=f"{tag}_lockstep", model=SERVE_MODEL, lockstep=lock,
             card=smi)
    # (d) the fork mix on the copy-based baseline (16-bit pools: dbs_copy's
    # 2-byte form) and on zero-copy
    fork = phase_fork16(torch, dev, smi, cfg, params, prompts,
                        2 * lock["plain_vs_fp32"], dtype)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    wide = _wide_forms16(torch, dev, dtype)
    gc.collect()
    torch.cuda.empty_cache()
    emit(phase=f"serve_{tag}", seconds=time.perf_counter() - t_phase,
         card=smi)
    return {"launches": res["launches"], "by_dtype": by, "by_form": by_form,
            "paged": res["parity"]["paged_attention"],
            "flash": res["parity"]["flash_attention"], "split": split,
            "lse": lse, "wide": wide, "rw": rw16, "fork": fork}


def _plain16_run(torch, dev, smi, cfg, params, prompts, res, kernel_tokens,
                 lock, name):
    """Phase 29 (c): the same requests on the plain 16-bit path, tokens
    equal but at near ties (the kernel run's top-2 margin under twice
    (b)'s plain path's distance to fp32)."""
    from repro_torch.serving.engine import GenRequest
    plain = _serve_engine(torch, cfg, params, dev,
                          plan=_plan16("dense", name), kernel="ref")
    clock = {"prefill": 0.0, "pumps": 0.0, "decode": 0.0}

    def timed(key, fn):
        def run(*a, **k):
            t = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            clock[key] += time.perf_counter() - t
            return out
        return run
    plain._prefill_one_zero = timed("prefill", plain._prefill_one_zero)
    plain._pump_writes = timed("pumps", plain._pump_writes)
    plain._step_fn = timed("decode", plain._step_fn)
    t0 = time.perf_counter()
    for rid, pr in enumerate(prompts):
        plain.submit(GenRequest(req_id=rid, prompt=pr, max_new=SERVE_NEW))
    plain_outs = plain.run(max_steps=10 * SERVE_NEW * len(prompts))
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    ties = _tokens_match(plain_outs, kernel_tokens, res["margin_of"],
                         f"{name} plain path", 2 * lock["plain_vs_fp32"])
    plain.volumes.close()
    del plain
    gc.collect()
    torch.cuda.empty_cache()
    emit(phase=f"{_tag16(torch, getattr(torch, name))}_vs_plain",
         model=SERVE_MODEL, lockstep=lock,
         requests=len(prompts), plain_run_seconds=plain_s,
         plain_tokens_per_s=len(prompts) * SERVE_NEW / plain_s,
         plain_seconds=clock,
         near_ties=ties, tie_margin=2 * lock["plain_vs_fp32"], card=smi)


def _rw_forms16(torch, eng, reads, writes, dtype=None):
    """``dbs_rw_read`` and ``dbs_rw_write`` on a 16-bit pool (``dtype``:
    bf16 by default, or fp16) at the zero-copy serving width: a copy in
    ``dtype`` of the 16-bit traffic's replica-0 engine pool ((E+1, 32,
    26624): one 52 KiB block a token) under its kept reads, then its kept
    replica-0 writes (payloads rounded to ``dtype``) replayed in order; bit
    for bit against the plain versions, timed as in phase 10. Emits a
    kernel_parity line each; returns their numbers."""
    dtype = dtype or torch.bfloat16
    pool0 = eng.volumes.device_pools()[0]
    pool = pool0.view(pool0.shape[0], pool0.shape[1], -1).to(dtype)
    got = {"dbs_rw_read": read_parity(torch, pool, reads),
           "dbs_rw_write": write_parity(
               torch, pool, [(s_, d_, lo, p_.to(dtype))
                             for s_, d_, lo, p_ in writes])}
    for name, f in got.items():
        emit(phase="kernel_parity", kernel=name,
             dtype=str(dtype).split(".")[1],
             width="zero-copy serving", pool_shape=list(pool.shape),
             equal=True, **{k: f[k] for k in (
                 "calls", "max_abs_err", "ms", "plain_ms", "bound_ms",
                 "library_ms", "bytes_per_call", "resources")})
    del pool
    torch.cuda.empty_cache()
    return got


def _fork_mix(torch, eng, prompts, forks=True):
    """BF16_FORK's traffic on ``eng``: its parents (request ids 0..),
    BF16_FORK[1] new tokens each, each forked once (child id 100 + parent)
    right after its BF16_FORK[2]-th token, the child running on for
    BF16_FORK[3] new tokens; without ``forks``, the parents alone (an
    independent decode of the same streams). Returns ``{request id:
    tokens}`` and the run's seconds."""
    from repro_torch.serving.engine import GenRequest
    n_par, n_new, fork_at, child_new = BF16_FORK
    t0 = time.perf_counter()
    for rid in range(n_par):
        eng.submit(GenRequest(req_id=rid, prompt=prompts[rid],
                              max_new=n_new))
    forked = set()
    for _ in range(4 * n_new):
        eng.step()
        for rid in range(n_par):
            g = eng.live.get(rid)
            if not forks or rid in forked or g is None:
                continue
            if len(g.out_tokens) > fork_at:
                raise AssertionError(f"request {rid} passed token {fork_at} "
                                     f"unforked")
            if len(g.out_tokens) == fork_at:
                if eng.fork(rid, 100 + rid,
                            max_new=fork_at + child_new) is None:
                    raise AssertionError(f"no slot or volume to fork {rid}")
                forked.add(rid)
        if all(g.done for g in eng.live.values()) and \
                len(forked) == (n_par if forks else 0):
            break
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    outs = {rid: list(g.out_tokens) for rid, g in eng.live.items()}
    want = {rid: n_new for rid in range(n_par)}
    if forks:
        want.update({100 + rid: fork_at + child_new for rid in range(n_par)})
    if {r: len(t) for r, t in outs.items()} != want:
        raise AssertionError(f"fork mix: tokens made "
                             f"{ {r: len(t) for r, t in outs.items()} }, "
                             f"not {want}")
    return outs, run_s


def phase_fork16(torch, dev, smi, cfg, params, prompts, tie_margin,
                 dtype=None):
    """Phase 29 (d) and 31 (d): BF16_FORK's mix on gemma2-2b's serve plan
    of the 16-bit ``dtype`` (bf16 by default, or fp16; the params'), first
    on the copy-based baseline (``kv_backend="host"``: its model-owned K/V
    pools of ``dtype``, CoW'd through ``dbs_copy`` once a pool at the
    first step after a fork), then on zero-copy (``fused``). Checked on
    each: every ``dbs_copy`` launch of the pool's dtype, launches on the
    baseline and none on zero-copy; no plain version called; each parent's
    and child's tokens equal an independent decode of the same streams on
    a second engine of the same backend (the TIE_MARGIN rule on the fork
    run's top-2 margins); the two backends' tokens equal under the same
    rule with ``tie_margin`` (twice (b)'s plain distance to fp32: their
    decode attends through other paths). Every kept copy held against the
    plain version bit for bit on a copy of a 16-bit pool and timed (phase
    14's check). Printed:
    tokens/s, prefill seconds, seconds in the CoW copies (baseline) and in
    the write pumps (zero-copy), launches, peak memory. Returns the copy
    parity and the launches for the kernels line."""
    import collections
    from repro_torch.kernels.dbs import copy_kernel
    from repro_torch.models import model as M
    from repro_torch.serving import engine as serving
    mods = _kernel_modules()
    dtype = dtype or torch.bfloat16
    name, tag = str(dtype).split(".")[1], _tag16(torch, dtype)
    t_phase = time.perf_counter()
    fields, outs, kept = {}, {}, []
    inner_copy, inner_decode = serving.dbs_copy_pool, M.decode_step
    for backend in ("host", "fused"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        eng = _serve_engine(torch, cfg, params, dev, kv_backend=backend,
                            plan=_plan16("cuda", name))
        clock = {"prefill": 0.0, "cow_copies": 0.0, "pumps": 0.0}

        def timed(name, fn):
            def run(*a, **k):
                t = time.perf_counter()
                out = fn(*a, **k)
                torch.cuda.synchronize()
                clock[name] += time.perf_counter() - t
                return out
            return run

        def copy(pool, src, dst, mask, **k):
            kept.append((pool, src.clone(), dst.clone(), mask.clone()))
            return inner_copy(pool, src, dst, mask, **k)
        margins = []
        if backend == "host":        # its decode is the model's step
            eng._prefill_one_host = timed("prefill", eng._prefill_one_host)
            serving.dbs_copy_pool = timed("cow_copies", copy)
            M.decode_step = _margin_step(torch, eng, inner_decode, margins)
        else:
            eng._prefill_one_zero = timed("prefill", eng._prefill_one_zero)
            eng._pump_writes = timed("pumps", eng._pump_writes)
            eng._step_fn = _margin_step(torch, eng, eng._step_fn, margins)
        for mod in mods:
            mod.reset_counts()
        try:
            outs[backend], run_s = _fork_mix(torch, eng, prompts)
        finally:
            serving.dbs_copy_pool, M.decode_step = inner_copy, inner_decode
        launches = {k: v for mod in mods for k, v in mod.LAUNCHES.items()}
        copy_by = dict(copy_kernel.LAUNCHES_BY_DTYPE)
        plain = {k: v for mod in mods for k, v in mod.PLAIN_CALLS.items()}
        peak = torch.cuda.max_memory_allocated(dev)
        margin_of = collections.defaultdict(lambda: float("inf"),
                                            _margin_map(torch, margins))
        if any(plain.values()):
            raise AssertionError(f"fork mix on {backend}: plain versions "
                                 f"ran on the card: {plain}")
        n_copy = launches["dbs_copy"]
        if backend == "host" and (n_copy <= 0 or copy_by[name] != n_copy
                                  or n_copy % len(_model_pools(eng))):
            raise AssertionError(f"the baseline's forks launched dbs_copy "
                                 f"{copy_by}, not the {name} pools' alone, "
                                 f"a launch a pool")
        if backend == "fused" and n_copy:
            raise AssertionError(f"zero-copy launched dbs_copy {n_copy} "
                                 f"times")
        if launches["rwkv6_scan"]:
            raise AssertionError(f"fork mix on {backend}: gemma2-2b "
                                 f"launched rwkv6_scan: {launches}")
        eng.volumes.close()
        del eng
        gc.collect()
        torch.cuda.empty_cache()
        # an independent decode of the same streams: the parents alone
        ref = _serve_engine(torch, cfg, params, dev, kv_backend=backend,
                            plan=_plan16("cuda", name))
        ref_outs, _ = _fork_mix(torch, ref, prompts, forks=False)
        ref.volumes.close()
        del ref
        gc.collect()
        torch.cuda.empty_cache()
        n_par, _n, fork_at, child_new = BF16_FORK
        want = {**ref_outs, **{100 + r: ref_outs[r][:fork_at + child_new]
                               for r in range(n_par)}}
        ties = _tokens_match(outs[backend], want, margin_of,
                             f"fork mix on {backend} against an independent "
                             f"decode")
        if backend == "fused":
            fused_margins = margin_of
        n_tok = sum(len(t) for t in outs[backend].values()) - n_par * fork_at
        fields[backend] = dict(
            run_seconds=run_s, tokens_per_s=n_tok / run_s,
            generated_tokens=n_tok, seconds=clock, launches=launches,
            dbs_copy_launches_by_dtype=copy_by, plain_calls=plain,
            near_ties_vs_independent=ties, max_memory_allocated=peak)
    cross = _tokens_match(outs["host"], outs["fused"], fused_margins,
                          "fork mix, baseline against zero-copy", tie_margin)
    pool0 = kept[0][0]
    e, page = pool0.shape[:2]
    copies = copy_parity(torch, pool0.reshape(e, page, -1).clone(),
                         [(s_.to(torch.int32), d_.to(torch.int32), m.bool())
                          for _p, s_, d_, m in kept])
    emit(phase="kernel_parity", kernel="dbs_copy", dtype=name,
         width=f"serving baseline ({tag} pools)",
         pool_shape=list(pool0.reshape(e, page, -1).shape),
         calls=len(kept), rows_copied=copies["rows_copied"], equal=True,
         **{k: copies[k] for k in ("max_abs_err", "ms", "plain_ms",
                                   "bound_ms", "library_ms",
                                   "bytes_per_call", "resources")})
    del kept, pool0
    emit(phase=f"serve_fork_{tag}", model=SERVE_MODEL,
         config=dict(n_slots=8, max_len=2048, kv_replicas=2,
                     attn_impl="cuda", compute_dtype=name,
                     param_dtype=name),
         parents=BF16_FORK[0], parent_new_tokens=BF16_FORK[1],
         fork_after_token=BF16_FORK[2], child_new_tokens=BF16_FORK[3],
         backends=fields, near_ties_baseline_vs_zero_copy=cross,
         tie_margin=tie_margin,
         seconds=time.perf_counter() - t_phase, card=smi)
    return {"copy": copies,
            "launches": {b: f["launches"] for b, f in fields.items()},
            "dbs_copy_by_dtype": fields["host"]["dbs_copy_launches_by_dtype"]}


@contextlib.contextmanager
def _kept_serving_calls(torch, keep_flash):
    """Count and keep the four serving kernels' calls of whatever engine
    runs inside: every kernel's counts zeroed on entry; kept, the flash
    calls ``keep_flash(kept, q, kw)`` accepts, every EXAMPLE_EVERY-th
    paged call (at most EXAMPLE_KEEP_PAGED), and the DBS read's and
    replica 0's write's inputs of every EXAMPLE_EVERY-th pump. Yields
    ``kept``; on exit ``kept["launches"]`` and ``kept["plain"]`` hold the
    counts of the run, read before anything else launches."""
    from repro_torch.core import backends
    from repro_torch.kernels.dbs import ops as dbs_ops
    from repro_torch.kernels.flash_attention import ops as f_ops
    from repro_torch.serving import engine as serving
    kept = {"paged": [], "flash": [], "read": [], "write": []}
    counts = {"paged": 0, "pumps": 0, "write_pump": -1}
    inner = {"fused": backends.fused_step,
             "paged": serving.paged_attention_pool_fwd,
             "flash": f_ops.flash_attention_fwd, "read": dbs_ops.dbs_rw_read,
             "write": dbs_ops.dbs_rw_write}

    def fused(*a, **k):
        counts["pumps"] += 1
        return inner["fused"](*a, **k)

    def paged(q, pool, table, lengths, **k):
        if counts["paged"] % EXAMPLE_EVERY == 0 and \
                len(kept["paged"]) < EXAMPLE_KEEP_PAGED:
            kept["paged"].append((q.clone(), table.clone(), lengths.clone(),
                                  dict(k)))
        counts["paged"] += 1
        return inner["paged"](q, pool, table, lengths, **k)

    def flash(q, k, v, **kw):
        if keep_flash(kept["flash"], q, kw):
            kept["flash"].append((q.clone(), k.clone(), v.clone(), dict(kw)))
        return inner["flash"](q, k, v, **kw)

    def read(pool, ext, block):
        if counts["pumps"] % EXAMPLE_EVERY == 1:
            kept["read"].append((ext.clone(), block.clone()))
        return inner["read"](pool, ext, block)

    def write(pool, src, dst, lane_of, payload, **k):
        n = counts["pumps"]
        if n % EXAMPLE_EVERY == 1 and counts["write_pump"] != n:
            counts["write_pump"] = n             # the pump's first replica
            kept["write"].append(tuple(t.clone() for t in (
                src, dst, lane_of, payload)))
        return inner["write"](pool, src, dst, lane_of, payload, **k)

    mods = _kernel_modules()
    for mod in mods:
        mod.reset_counts()
    backends.fused_step = fused
    serving.paged_attention_pool_fwd = paged
    f_ops.flash_attention_fwd = flash
    dbs_ops.dbs_rw_read, dbs_ops.dbs_rw_write = read, write
    try:
        yield kept
        torch.cuda.synchronize()
        kept["launches"] = {k: v for mod in mods
                            for k, v in mod.LAUNCHES.items()}
        kept["plain"] = {k: v for mod in mods
                         for k, v in mod.PLAIN_CALLS.items()}
    finally:
        backends.fused_step = inner["fused"]
        serving.paged_attention_pool_fwd = inner["paged"]
        f_ops.flash_attention_fwd = inner["flash"]
        dbs_ops.dbs_rw_read = inner["read"]
        dbs_ops.dbs_rw_write = inner["write"]


def _first_two(kept, q, kw) -> bool:
    return len(kept) < 2


def _example_train_lm(torch, dev, smi, tmp):
    """``repro_torch.examples.train_lm`` at its own sizes (8 x 256 tokens a
    step, its bf16 plan, 67.7M params) for EXAMPLE_TRAIN_STEPS steps (cut
    from 300) with its checkpoints to two replicas under ``tmp`` (every 50
    steps and at the end; each save timed); then a restart resumes at the
    last step with the params and AdamW state bit for bit. The loss must
    fall (the mean of the last ten steps below the first ten's) and no
    kernel launch (the kernels refuse grad)."""
    import numpy as np
    from repro_torch.checkpoint import replicated
    from repro_torch.examples import train_lm
    from repro_torch.models.model import tree_leaves
    from repro_torch.training.trainer import Trainer
    saves = []
    inner = replicated.ReplicatedCheckpoint.save

    def save(self, name, step, tree, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = inner(self, name, step, tree, **kw)
        saves.append((step, time.perf_counter() - t, len(self.healthy())))
        return out
    mods = _kernel_modules()
    for mod in mods:
        mod.reset_counts()
    torch.cuda.reset_peak_memory_stats()
    replicated.ReplicatedCheckpoint.save = save
    try:
        out = train_lm.main(["--steps", str(EXAMPLE_TRAIN_STEPS),
                             "--ckpt-dir", tmp, "--device", "cuda"])
    finally:
        replicated.ReplicatedCheckpoint.save = inner
    peak = torch.cuda.max_memory_allocated(dev)
    launches = {k: v for mod in mods for k, v in mod.LAUNCHES.items()}
    state = {"params": out["params"], "opt": out["opt_state"]}
    version = sum(t.numel() * t.element_size() for t in tree_leaves(state))
    t0 = time.perf_counter()
    tr = Trainer(train_lm.CFG_100M, train_lm.PLAN, None,
                 ckpt_dirs=out["ckpt_dirs"], device=dev)
    torch.cuda.synchronize()
    resume_s = time.perf_counter() - t0
    resumed = tr.step == out["step"] == EXAMPLE_TRAIN_STEPS and all(
        a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(
            tree_leaves({"params": tr.params, "opt": tr.opt_state}),
            tree_leaves(state)))
    tr.ckpt.close()
    del tr
    hist = out["history"]
    losses = [h["loss"] for h in hist]
    step_s = float(np.median([h["step_time_s"] for h in hist[1:]]))
    tokens = out["tokens"] / EXAMPLE_TRAIN_STEPS
    save_s = [t for _, t, _ in saves]
    res = dict(lines=out["lines"], steps=EXAMPLE_TRAIN_STEPS,
               reduced={"steps": [300, EXAMPLE_TRAIN_STEPS]},
               params=sum(t.numel() for t in tree_leaves(out["params"])),
               first_losses=losses[:3], last_losses=losses[-3:],
               median_step_s_steps_2_on=step_s,
               tokens_per_s=tokens / step_s,
               run_seconds=out["seconds"],
               run_tokens_per_s=out["tokens"] / out["seconds"],
               straggler_events=out["straggler_events"],
               store_bytes=out["ckpt_capacity"], version_bytes=version,
               saves=[dict(step=st, seconds=t, replicas=r)
                      for st, t, r in saves],
               save_mb_per_s=[version * r / 2**20 / t for _, t, r in saves],
               resume_seconds=resume_s,
               resume_mb_per_s=version / 2**20 / resume_s,
               resumed_bit_equal=resumed, max_memory_allocated=peak,
               kernel_launches=launches)
    del out, state
    if not (all(math.isfinite(x) for x in losses)
            and np.mean(losses[-10:]) < np.mean(losses[:10])):
        raise AssertionError(f"train_lm: losses {losses}")
    if not resumed or any(launches.values()) or len(saves) < 2:
        raise AssertionError(f"train_lm: resumed {resumed}, launches "
                             f"{launches}, saves {saves}")
    return res


def phase_examples(torch, dev, smi):
    """Phase 30: the four examples through their ``main`` on the card, as
    ``python -m repro_torch.examples.<name>`` runs them, at the reference
    examples' own sizes (smoke widths for the three serving ones, their
    prefill through flash and their decode through paged; train_lm's
    steps cut). In each serving example kernels #1, #2, #4 and #5 (DBS
    write and read, paged and flash attention) must launch and no plain
    version run (``_kept_serving_calls``); the kept calls are then held
    against the plain versions on the example's own engine pool, as in
    phase 10. serve_paged must leave no extent used; fork_sessions' forks
    must be prefixes of the parent (the example raises otherwise, and it
    is checked again here); quickstart must resume at step 15. Tokens/s
    of each serving example; ``_example_train_lm``'s figures. Returns
    each kernel's launches by example."""
    from repro_torch.examples import fork_sessions, quickstart, serve_paged
    lines, launches_by, parity_by = {}, {}, {}
    for name, mod, keep in (("serve_paged", serve_paged, _keep_local_global),
                            ("fork_sessions", fork_sessions, _first_two),
                            ("quickstart", quickstart, _first_two)):
        torch.cuda.reset_peak_memory_stats()
        with _kept_serving_calls(torch, keep) as kept:
            out = mod.main(["--device", "cuda"])
        launches, plain = kept["launches"], kept["plain"]
        eng = out["engine"]
        need = ("dbs_rw_write", "dbs_rw_read", "paged_attention",
                "flash_attention")
        if min(launches[k] for k in need) <= 0 or any(plain.values()):
            raise AssertionError(f"{name}: launches {launches}, plain "
                                 f"calls {plain}")
        if name == "serve_paged" and out["dbs"]["extents_used"]:
            raise AssertionError(f"serve_paged: {out['dbs']}")
        if name == "fork_sessions":
            p = out["outs"][0]
            if any(out["outs"][r] != p[:len(out["outs"][r])]
                   for r in (1, 2)):
                raise AssertionError(f"fork_sessions: {out['outs']}")
        if name == "quickstart" and out["resumed"] != quickstart.TRAIN_STEPS:
            raise AssertionError(f"quickstart resumed at {out['resumed']}")
        parity = {"paged_attention": phase_paged_kernel(torch, eng, kept),
                  "flash_attention": phase_flash_kernel(torch, kept),
                  "dbs_rw_read": phase_read_kernel_serve(torch, eng,
                                                         kept["read"]),
                  "dbs_rw_write": phase_write_kernel_serve(torch, eng,
                                                           kept["write"])}
        emit(phase="example", name=name, lines=out["lines"],
             tokens=out["tokens"], seconds=out["seconds"],
             tokens_per_s=out["tokens"] / out["seconds"],
             launches=launches, plain_calls=plain,
             max_memory_allocated=torch.cuda.max_memory_allocated(dev),
             kept={k: len(v) for k, v in kept.items()
                   if k not in ("launches", "plain")},
             parity={k: {f: v[f] for f in ("max_abs_err", "ms", "plain_ms",
                                          "bound_ms")}
                     for k, v in parity.items()}, card=smi)
        lines[name] = out["lines"]
        launches_by[name] = launches
        parity_by[name] = parity
        eng.volumes.close()
        del out, eng, kept
        gc.collect()
        torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="chip-smoke-train-lm-")
    try:
        tlm = _example_train_lm(torch, dev, smi, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit(phase="example", name="train_lm", **tlm, card=smi)
    launches_by["train_lm"] = tlm["kernel_launches"]
    return launches_by, parity_by


def _forms16_keys(got, tag, write_k, read_k, copy_k, paged_k, flash_k,
                  rwkv_k) -> None:
    """Phase 29's or 31's results (``_serve16``) into the kernels line's
    entries under ``<tag>_*`` keys (bf16 or f16): every entry's launches on
    the 16-bit serve path and on the fork mix (the baseline and
    zero-copy), the paged and flash entries' launches by dtype and form,
    and each form's kept-call numbers."""
    for k in (write_k, read_k, copy_k, paged_k, flash_k, rwkv_k):
        k[f"launches_{tag}_serve_path"] = got["launches"][k["name"]]
        k[f"launches_{tag}_fork_path"] = {
            b: n[k["name"]] for b, n in got["fork"]["launches"].items()}
    copy_k[f"launches_{tag}_fork_path_by_dtype"] = got["fork"][
        "dbs_copy_by_dtype"]
    copy_k.update(_width_keys(f"{tag}_fork", got["fork"]["copy"]))
    for k in (write_k, read_k):
        k.update(_width_keys(f"{tag}_serve", got["rw"][k["name"]]))
    for k in (paged_k, flash_k):
        k[f"launches_{tag}_serve_path_by_dtype"] = got["by_dtype"][k["name"]]
        k[f"launches_{tag}_serve_path_by_form"] = got["by_form"][k["name"]]
    paged_k.update(**_width_keys(tag, got["paged"]),
                   **_width_keys(f"{tag}_split", got["split"]),
                   **_width_keys(f"{tag}_lse", got["lse"]),
                   **_width_keys(f"{tag}_wide_split",
                                 got["wide"]["paged_split"]),
                   **_width_keys(f"{tag}_wide_pool",
                                 got["wide"]["paged_pool"]))
    flash_k.update(**_width_keys(tag, got["flash"]),
                   **_width_keys(f"{tag}_wide", got["wide"]["flash"]),
                   **_width_keys(f"{tag}_narrow_mma",
                                 got["wide"]["flash_narrow_mma"]))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--max-pages", type=int, default=8192,
                    help="volume size in 128 KiB pages (1 GiB by default)")
    args = ap.parse_args()
    args.n_extents = args.max_pages * 3 // 2    # room for CoW and clones
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "kernels" / "_build.py").is_file():
        print(f"chip_smoke: the port's sources are not under {SRC}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    global BF16_FLOPS_PER_S, FP32_FLOPS_PER_S, HBM_BYTES_PER_S, \
        TF32X3_FLOPS_PER_S
    from repro_torch.utils.machine import (BF16_FLOPS_PER_S,
                                           FP32_FLOPS_PER_S, HBM_BYTES_PER_S,
                                           TF32X3_FLOPS_PER_S)
    dev = torch.device("cuda", 0)
    smi = smi_line()
    emit(phase="env", python=sys.version.split()[0], torch=torch.__version__,
         cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
         card=smi, count=torch.cuda.device_count())

    torch.backends.cuda.matmul.allow_tf32 = False    # fp32 means fp32
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    _build.build_all(force=True)
    emit(phase="build", wall_seconds=time.perf_counter() - t0,
         seconds=_build.build_seconds, libraries=[
             str(_build.library_path(n).relative_to(ROOT))
             for n in _build.SOURCES],
         ptxas={n: [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln]
                for n, log in _build.build_log.items()})

    def free():
        gc.collect()         # the managers' reference cycles hold pools
        torch.cuda.empty_cache()

    launch_floor = phase_launch_floor(torch, dev, smi)
    write_k = phase_write_kernel(torch, args, dev)
    copy_crafted_err = phase_copy_kernel(torch, args, dev)
    mgr, launches, n_steps, kept, main_out = phase_main(torch, args, dev,
                                                        smi)
    trace_ops = main_out["ops"]
    read_k = phase_read_kernel(torch, mgr, kept["dbs_rw_read"])
    fused_compute = phase_compute(torch, smi, mgr, kept, "fused")
    del kept
    phase_no_sync(torch, mgr)     # writes blocks the shadow does not hold
    mgr.close()
    del mgr
    free()
    for k in (write_k, read_k):
        k["launches"] = launches[k["name"]]
        k["launches_per_step"] = launches[k["name"]] / n_steps
    # the ladder's columns on one cut trace, once each: the fused step on
    # the hand-written kernels, the fused step on the copy entry (whose
    # kept dbs_copy calls time the kernel), the unfused host-dispatched
    # engine; then the per-request loop over the first few hundred ops
    ladder, ladder_out = {}, {}
    for backend, kernel in LADDER:
        mgr, got, steps, kept, out = phase_main(
            torch, args, dev, smi, backend=backend, kernel=kernel,
            n_ops=LADDER_OPS)
        ladder[f"{backend}/{kernel}"] = out["ops_per_s"]
        ladder_out[f"{backend}/{kernel}"] = out
        if kernel == "copy":
            copy_k = phase_copy_kernel_main(torch, mgr, kept["dbs_copy"])
            copy_k.update(launches=got["dbs_copy"],
                          launches_per_step=got["dbs_copy"] / steps,
                          crafted_max_abs_err=copy_crafted_err)
        del kept
        mgr.close()
        del mgr
        free()
    mgr, _l, _s, kept, out = phase_main(torch, args, dev, smi,
                                        backend="loop", kernel="torch",
                                        n_ops=LOOP_OPS, max_ops=LOOP_MAX_OPS)
    ladder["loop/torch"] = out["ops_per_s"]
    mgr.close()
    del mgr, kept
    free()
    # the paper's baseline and its first two steps on the same trace:
    # upstream and +frontend dispatch one request at a time, so they take
    # the loop column's cut
    controller = {}
    for column, kw, per_request in CONTROLLER_LADDER:
        cut = (dict(n_ops=LOOP_OPS, max_ops=LOOP_MAX_OPS) if per_request
               else dict(n_ops=LADDER_OPS))
        mgr, _l, _s, kept, out = phase_main(torch, args, dev, smi,
                                            column=column, **kw, **cut)
        del kept
        controller[column] = {k: out[k] for k in (
            "ops", "ops_per_s", "mib_per_s", "pumps", "host_syncs_per_pump",
            "reads_checked")}
        ladder[column] = out["ops_per_s"]
        mgr.close()
        del mgr, out
        free()
    emit(phase="controller_ladder", columns=controller,
         beside={"+dbs": ladder["slots/torch"],
                 "+fused": ladder["fused/cuda"]}, card=smi)
    emit(phase="ladder", ops=LADDER_OPS, ops_per_s=ladder, card=smi)
    phase_layer_rows(torch, args, dev, smi)
    rebuild = phase_rebuild(torch, args, dev, smi, trace_ops)
    free()
    phase_replication(torch, args, dev, smi)
    phase_snapshot_depth(torch, args, dev, smi)
    free()
    for k in (write_k, read_k):
        k["launches_rebuild_path"] = rebuild["launches"][k["name"]]

    # the shards slice: the byte API on the sharded pool beside the fused
    # column (its kernels' kept calls held against the plain versions, one
    # pump under sync-debug "error"), Table III, the per-shard failover
    mgr, sh_launches, _s, kept, sh_out = phase_main(
        torch, args, dev, smi, column="+sharded", **sharded_config(args))
    phase_no_sync_sharded(torch, mgr)
    sh_write, sh_read = phase_sharded_kernels(torch, mgr, kept)
    del kept
    mgr.close()
    del mgr
    free()
    fused = ladder_out["fused/cuda"]
    per_replica = {
        "fused": {"dbs_rw_write": fused["launches"]["dbs_rw_write"]
                  / fused["write_steps"] / REPLICAS,
                  "dbs_rw_read": fused["launches"]["dbs_rw_read"]
                  / (fused["write_steps"] + fused["read_only_steps"])},
        "sharded": {"dbs_rw_write": sh_out["write_launches_per_write_pump"]
                    / REPLICAS,
                    "dbs_rw_read": sh_out["launches_per_pump"]["dbs_rw_read"]
                    / REPLICAS}}
    if per_replica["fused"] != per_replica["sharded"]:
        raise AssertionError(f"launches a pump per replica differ: "
                             f"{per_replica}")
    emit(phase="shards", shards=SHARDS, ops=sh_out["ops"],
         ops_per_s={"+sharded": sh_out["ops_per_s"],
                    "+fused": fused["ops_per_s"]},
         mib_per_s={"+sharded": sh_out["mib_per_s"],
                    "+fused": fused["mib_per_s"]},
         pumps={"+sharded": sh_out["pumps"], "+fused": fused["pumps"]},
         ops_per_pump={"+sharded": sh_out["ops_per_pump"],
                       "+fused": fused["ops_per_pump"]},
         host_syncs_per_pump={"+sharded": sh_out["host_syncs_per_pump"],
                              "+fused": fused["host_syncs_per_pump"]},
         launches_per_pump_per_replica=per_replica, card=smi)
    for k, extra in ((write_k, sh_write), (read_k, sh_read)):
        k.update(extra, launches_sharded_path=sh_launches[k["name"]],
                 launches_per_pump_sharded=sh_out["launches_per_pump"][
                     k["name"]])
    phase_table3(torch, args, dev, smi)
    phase_shard_failover(torch, args, dev, smi, sh_out["ops"])
    free()

    # the ring slice: the byte API's full trace on the ring (control
    # in-band), the storage functions in-band, two guarded pumps; the ring
    # at S=4 with an in-band fail and rebuild; the ring on the copy entry
    mgr, ring_launches, _s, kept, ring_out = phase_main(
        torch, args, dev, smi, backend="ring", column="+ring")
    ring_compute = phase_compute(torch, smi, mgr, kept, "ring")
    phase_no_sync_ring(torch, mgr)
    del kept
    mgr.close()
    del mgr
    free()
    per_replica["ring"] = {
        "dbs_rw_write": ring_out["launches"]["dbs_rw_write"]
        / ring_out["write_steps"] / REPLICAS,
        "dbs_rw_read": ring_out["launches"]["dbs_rw_read"]
        / (ring_out["write_steps"] + ring_out["read_only_steps"])
        / REPLICAS}
    if per_replica["ring"] != per_replica["fused"]:
        raise AssertionError(f"launches a pump per replica differ: "
                             f"{per_replica}")
    emit(phase="ring", ops=ring_out["ops"],
         ops_per_s={"+ring": ring_out["ops_per_s"],
                    "+fused (main path)": main_out["ops_per_s"]},
         mib_per_s={"+ring": ring_out["mib_per_s"],
                    "+fused (main path)": main_out["mib_per_s"]},
         pumps=ring_out["pumps"], ops_per_pump=ring_out["ops_per_pump"],
         host_syncs_per_pump={"+ring": ring_out["host_syncs_per_pump"],
                              "+fused": main_out["host_syncs_per_pump"]},
         launches_per_pump_per_replica=per_replica,
         steps_by_signature=ring_out["steps_by_signature"], card=smi)
    ring_sh = phase_ring_shards(torch, args, dev, smi, sh_out["ops"])
    free()
    mgr, ring_copy, _s, kept, _o = phase_main(
        torch, args, dev, smi, backend="ring", kernel="copy",
        n_ops=LADDER_OPS, column="+ring copy")
    del kept
    mgr.close()
    del mgr
    free()
    for k in (write_k, read_k):
        k.update(launches_ring_path=ring_launches[k["name"]],
                 launches_ring_s4_path=ring_sh["launches"][k["name"]],
                 launches_ring_storage_functions=ring_compute[k["name"]],
                 launches_fused_storage_functions=fused_compute[k["name"]],
                 launches_per_pump_ring=ring_out["launches_per_pump"][
                     k["name"]])
    copy_k.update(launches_ring_copy_column=ring_copy["dbs_copy"])

    # the durability slice: the journal on and off, crash recovery (full
    # replay, an export's install plus tail replay, the ring), the tier
    tmp = tempfile.mkdtemp(prefix="chip-smoke-durability-")
    try:
        crashed = phase_journal(torch, args, dev, smi, tmp)
        journal_launches = crashed["launches"]
        rec_launches = phase_recovery(torch, args, dev, smi, tmp, crashed)
        del crashed
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    free()
    tier_launches = phase_tier(torch, args, dev, smi,
                               main_out["host_syncs_per_pump"])
    free()
    harness_launches = phase_harness(torch, args, dev, smi)
    free()
    for k in (write_k, read_k, copy_k):
        k["launches_harness_path"] = harness_launches[k["name"]]
    for k in (write_k, read_k):
        k.update(
            launches_journal_path=journal_launches[k["name"]],
            launches_recovery_path=rec_launches["fused_full_replay"][
                k["name"]],
            launches_recovery_export_path=rec_launches["fused_export"][
                k["name"]],
            launches_ring_recovery_path=rec_launches["ring_full_replay"][
                k["name"]],
            launches_tier_path=tier_launches[k["name"]])

    eng, serve, (cfg, params, prompts) = phase_serve(torch, dev, smi)
    fused_tokens = {rid: list(serve["outs"][rid])
                    for rid in range(SERVE_REQUESTS)}
    phase_no_sync_serve(torch, eng)
    phase_profile_serve(torch, eng, smi)
    eng.volumes.close()
    del eng
    free()
    serve_launches = serve["launches"]
    paged_k = serve["parity"]["paged_attention"]
    flash_k = serve["parity"]["flash_attention"]
    for k in (paged_k, flash_k):
        k["launches"] = serve_launches[k["name"]]
    flash_k["launches_serve_path_by_form"] = serve["launches_by_form"][
        "flash_attention"]
    paged_k["launches_per_decode_step"] = (serve_launches["paged_attention"]
                                           / serve["counts"]["decode_steps"])
    for k in (write_k, read_k):
        k.update(_width_keys("serve", serve["parity"][k["name"]]),
                 launches_serve_path=serve_launches[k["name"]],
                 launch_floor_ms=launch_floor)
    del serve

    eng, kept, host_traffic, host_fork = phase_serve_host(
        torch, dev, smi, cfg, params, prompts)
    serve_copy = phase_copy_kernel_serve(torch, kept)
    del kept
    eng.volumes.close()
    del eng
    free()
    copy_k.update(launches_serve_host_traffic=host_traffic,
                  launches_serve_host_fork=host_fork,
                  serve_width_ms=serve_copy["ms"],
                  serve_width_plain_ms=serve_copy["plain_ms"],
                  serve_width_bound_ms=serve_copy["bound_ms"],
                  serve_width_library_ms=serve_copy["library_ms"],
                  serve_width_max_abs_err=serve_copy["max_abs_err"],
                  serve_width_bytes_per_call=serve_copy["bytes_per_call"],
                  serve_width_zero_row_calls=serve_copy["zero_row_calls"],
                  serve_width_resources=serve_copy["resources"],
                  launch_floor_ms=launch_floor)
    phase_host_vs_zero(torch, dev, cfg, params, prompts)
    phase_serve_pool(torch, dev, smi, cfg, params, prompts)
    free()
    sh_serve = phase_serve_sharded(torch, dev, smi, cfg, params, prompts,
                                   fused_tokens)
    for k in (paged_k, flash_k):
        k["launches_sharded_serve_path"] = sh_serve[k["name"]]
    free()
    ring_serve = phase_serve_ring(torch, dev, smi, cfg, params, prompts,
                                  fused_tokens)
    for k in (paged_k, flash_k, write_k, read_k):
        k["launches_ring_serve_path"] = ring_serve[k["name"]]
    del cfg, params, prompts
    free()

    eng, params, kept, rwkv_launches, rwkv_counts = phase_serve_rwkv(
        torch, dev, smi)
    rwkv_k = _rwkv_entry(phase_rwkv_kernel(torch, kept), rwkv_launches,
                         rwkv_counts, eng.cfg.n_layers)
    del eng, params, kept
    free()

    # the hybrid and MoE families at full width; then MLA with the MTP
    # head (deepseek-v3, its depth cut) and the multi-codebook heads
    # (musicgen-large, max_len cut); each with the previous model freed
    for tag, model, seed, kw in (
            ("hybrid", HYBRID_MODEL, SEED + 6, {}),
            ("moe", MOE_MODEL, SEED + 7, {}),
            ("mla", MLA_MODEL, SEED + 9, dict(n_layers=MLA_LAYERS,
                                              mtp=True)),
            ("audio", AUDIO_MODEL, SEED + 10, dict(max_len=AUDIO_MAX_LEN,
                                                   lengths=AUDIO_PROMPT))):
        fam = phase_serve_family(torch, dev, smi, model, seed, **kw)
        free()
        for k in (write_k, read_k, paged_k, flash_k):
            k[f"launches_{tag}_serve_path"] = fam["launches"][k["name"]]
            k.update(_width_keys(tag, fam[k["name"]]))
        paged_k.update(_width_keys(f"{tag}_split", fam["split"]))
        paged_k[f"launches_{tag}_serve_path_by_instance"] = fam[
            "paged_by_instance"]
        flash_k[f"launches_{tag}_serve_path_by_form"] = fam["flash_by_form"]
        if fam["mtp_flash_launches"] is not None:
            flash_k["launches_mtp_path"] = fam["mtp_flash_launches"]
    flash_k.update(_width_keys("f32_narrow_mma", _flash_narrow_f32(torch,
                                                                   dev)))
    free()

    # phase 28's counts on the CPU alone, started now: they run beside the
    # training and checkpoint phases (the card's and the disk's work) and
    # are collected before phase 28's timed steps
    dry_dir = tempfile.mkdtemp(prefix="chip-smoke-dryrun-")
    dry_runs = start_dryruns(dry_dir)
    try:
        # the training slice: one step at full width (two layers) on the
        # card against the CPU, in fp32 and on the bf16 plan, gemma2-2b
        # trained at full depth, then checkpoints
        parity_params, parity_batch, parity_g32 = phase_train_parity(
            torch, dev, smi)
        free()
        phase_train_parity_bf16(torch, dev, smi, parity_params,
                                parity_batch, parity_g32)
        del parity_batch, parity_g32
        free()
        train32 = phase_train(torch, dev, smi)
        train_launches = train32["kernel_launches"]
        free()
        train16_launches = phase_train_bf16(torch, dev, smi, train32)[
            "kernel_launches"]
        free()
        # the mesh on one card: phase 26's checkpoint restored as DTensors
        keep = tempfile.mkdtemp(prefix="chip-smoke-train-")
        try:
            saved = phase_checkpoint(torch, dev, smi, parity_params, keep)
            free()
            dist_checks = phase_distributed(torch, dev, smi, parity_params,
                                            saved, keep)
        finally:
            shutil.rmtree(keep, ignore_errors=True)
        del parity_params
        free()
        # the dry run: the accounting held against the card; then phase 29
        # (gemma2-2b on its bf16 serve plan)
        dry_launches, dry16_launches, bf16 = phase_dryrun(
            torch, dev, smi, dry_runs,
            beside=lambda: phase_serve_bf16(torch, dev, smi))
    finally:
        stop_dryruns(dry_runs)
        shutil.rmtree(dry_dir, ignore_errors=True)
    free()
    paged_k["check_calls_distributed_phase"] = dist_checks
    for k in (write_k, read_k, copy_k, paged_k, flash_k, rwkv_k):
        k["launches_train_path"] = train_launches[k["name"]]
    for k in (write_k, read_k, copy_k, flash_k, rwkv_k):
        k["launches_dryrun_path"] = 0
        k["launches_dryrun_bf16_path"] = 0
    paged_k["launches_dryrun_path"] = dry_launches
    paged_k["launches_dryrun_bf16_path"] = dry16_launches
    _forms16_keys(bf16, "bf16", write_k, read_k, copy_k, paged_k, flash_k,
                  rwkv_k)
    for k in (write_k, read_k, copy_k, paged_k, flash_k, rwkv_k):
        k["launches_train_bf16_path"] = train16_launches[k["name"]]

    # the examples as a user runs them
    ex_launches, ex_parity = phase_examples(torch, dev, smi)
    free()
    for k in (write_k, read_k, copy_k, paged_k, flash_k, rwkv_k):
        k["launches_examples"] = {name: got[k["name"]]
                                  for name, got in ex_launches.items()}
    for name, parity in ex_parity.items():
        for k in (write_k, read_k, paged_k, flash_k):
            k.update(_width_keys(f"example_{name}", parity[k["name"]]))

    # phase 31: gemma2-2b on its fp16 serve plan
    f16 = phase_serve_f16(torch, dev, smi)
    free()
    _forms16_keys(f16, "f16", write_k, read_k, copy_k, paged_k, flash_k,
                  rwkv_k)
    print(json.dumps({"kernels": [write_k, read_k, copy_k, paged_k,
                                  flash_k, rwkv_k]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
