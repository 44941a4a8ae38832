#!/usr/bin/env python3
"""Run the PyTorch/CUDA port on one NVIDIA Hopper GPU, end to end.

    python3 chip_smoke.py        # from the repository root

Phases (any failure raises, and the script exits non-zero before it
prints a result):
  1. build every CUDA kernel from kernels/csrc (one nvcc per source, all
     at once) and the port's host C++ library (native/, g++), print the
     card's name and power limit, the device topology as
     `python -m bench_torch --devices` prints it, each source's launch caps (pack_prefix:
     its most threads a block, cells a thread, and the SM count and
     shared memory a block may opt into, from which it sizes its grid),
     and whether the native library loaded and with which capabilities;
  2. hold each kernel against its plain PyTorch version on the card, on
     the same inputs, exactly (integer and bool outputs, tolerance 0):
     kernel 1 alone (materialize), the slab's one launch (kernel 1 with
     the summary wire as its epilogue: materialize_wire) with the doc's
     scratch in shared memory and in global lanes, and summary_wire alone
     with its sort keys in shared memory and in global scratch, full and
     lean, at the bulk slab (4096 docs x 1024 rows, 1 actor), a mesh
     rank's share of it (1024 x 1024), a multi-actor batch (1024 x 512, 3
     actors, half text) and one long doc (1 x 65536); pack_prefix on the
     inputs the sidecar pack hands it at the slab, at a ragged slab
     (partial windows, an empty doc, a shared feed, values outside int16)
     and at one doc of 65,536 rows (int32 row planes): its 11 wire
     planes, the slab launch's flags and slot, and the five ranges it
     folds (also the batch's own); at the same three, the host route's
     planes (HM_DEVICE_PACK=0: the native hm_pack_prefix) byte-equal to
     the kernel's; the four clock kernels at the mirror's capacity of
     BASELINE config 5 (131072 x 64): the pairwise ops (also at A = 3
     and A = 1024, full and broadcast rows; and every op on each of
     clock_pair's routes: the device route with the row on either side,
     the by-value query on either side with the result on the card and
     through the pinned buffer, at G = 1 .. 32 lanes a row on the int4
     and the scalar route, A = 1 .. 1024 with R = 1 and odd R, and a base
     one int off 16-byte alignment), the scatter-max with 1,000
     and 65,536 triples piled on one cell (and its parameter route, host
     triples in the launch, at 1,024 and at 2 x its per-launch cap + 1,
     with triples outside the matrix), the column max (also at
     [5, 3] and on negative clocks), top-k with mass ties and INT32_INF
     rows at k = 1, 64 and D, ties on both sides of every tile boundary,
     k = tile + 1 and 131,072 - 77 rows, on both of its routes (the
     tiled select and the large-k sort across blocks); the three
     read-serving kernels at B in {1, 8, 64} x N in {64, 1024, 65536},
     each shape with every synthetic scenario (ops/synth.py synth_serve_lanes: misses,
     all-matching rows, mass rank ties, ranks at the int32 ends) and a
     pad batch slot, and serve_order at (B, N) in {(1, 1024), (8, 1024),
     (cap + 2, 64), (3, 65536)} over ops/synth.py synth_order_lanes' cases
     (head ties, no live row, every row live, ranks at both int32 ends:
     live rows of key INT32_MAX in the tail), which cover its launches
     split over the batch and its global route; the ring all-gather on
     virtual ranks of this card at
     n in {2, 3, 4, 8} ranks x rows in {1, 7, 1024, 4096} x W in {1, 3,
     708, 1540, 4096} bytes on the push route, and at rows in {1, 1024} x
     W in {3, 1540} also through the flagged launch (the peer route's
     arrival protocol on one card), against ring_gather_plain; the min
     mode of
     the column reduce at [5, 3] and [8, 131072], and on negative values;
     both modes of the column reduce on both of its routes (the one-launch
     columns route for at most 64 rows, the tall route above): [2, 50000],
     [4, 64], [64, 1000] and [65, 1000], [2, 4099], each on clocks,
     negative values and the int32 ends, and a [3, 4096] view whose base
     sits 4 bytes past an aligned address; serve_counts at B in {1, 8,
     512} x N in {2, 1024, 65536} and at its launch cap + 2 entries (a
     split launch), from two threads at once, and in turn with
     serve_order on one thread (the one pinned buffer they share);
     serve_lookup at B in {1, 8, 64, 512} x N in {64, 1024, 65536} and
     at its launch cap + 2 entries, from two threads at once, and in
     turn with serve_order and serve_counts on one thread;
     the live tick's entry `materialize_live_device` against its plain
     version on the CPU, on the padded tick batches of seeded live
     columns (INC ops, text) at (D, N) = (1, 262144) with A and K at
     their bucket floors and (8, 32768) with A = 8, K = 64, at [3, 16384]
     (an odd D) with doc_kernel.cu's two routes forced and byte-equal,
     and on both sides of each boundary of the entry's route rule: [1,
     8192] and [1, 16384]; [SMs // 2, 16384] and [SMs // 2 + 1, 16384],
     each case's route held to the rule;
  3. drive each main path through the user entry points, its launch
     counts set to 0 just before it and read just after:
     a. the first slice: the slab dispatch `run_batch_full` (full and
        lean: one launch each) and a slab of one long doc (the many-block
        route, then summary_wire alone) with their host decode, and
        `materialize_batch` / `summarize_columnar` over 64 distinct
        histories, checked against the same entries run on the CPU;
     b. the sidecar slice: 8 template feeds written to column sidecars on
        disk and compacted, 4096 docs packed from them on the card by
        `pack_docs_columns`, `run_batch_full` and `fetch_summary`; live
        counts of every doc and decoded patches of 64 docs are held
        against the first slice's path (`pack_docs` over the same
        histories); pack_prefix and materialize_wire must each have
        launched once, materialize and summary_wire never (one launch
        for kernels 1-2 a slab); the dispatch must run on the pack's
        device lanes (`host_args` never called) and upload the pred edges
        and the actor map alone (the `slab.h2d_bytes` counter);
     c. the clock slice: BASELINE config 5 (`bench.py` `_config5_union`)
        on the card — a DeviceClockMirror seeded with 100,000 docs x 64
        actors, then 1,000 `update`s, `union()`, `dominated(q)` and
        `top_k_dominated(q, 64)`, each answer and the whole matrix equal
        to a mirror on the CPU fed the same calls, with exactly one
        launch each of clock_scatter, clock_union, clock_pair and
        clock_topk; then a sqlite ClockStore with a mirror attached
        (2,000 docs x 16 actors, a seeded mix of update, update_many,
        set and delete_doc), `union_query` / `dominated_query` on the
        mirror route and the doc-subset route, equal to the same store
        on the CPU;
     d. the read slice: bench.py's `_config_read` serving configuration —
        a corpus of 2,048 docs x 1,024 ops written with the port's
        `make_corpus` to a temporary directory (its .sig sidecars only
        when the host library has libsodium), `Repo(path)`,
        `open_many` of all of them and `fetch_bulk_summaries()`, the
        32-doc hot set made resident, then 8 reader threads issuing
        4,000 `len` reads (90% over the hot set, RNG seed 0xEAD5), timed
        read by read; the host twin on the same 4,000 reads; the same
        window again under torch.profiler, residency dropped first so it
        pays the same installs; then a mixed pass over the hot set
        (lookup of k0..k9, text, index and len of the text and of the
        root); every answer equal to `host_read` (the HM_SERVE=0 twin)
        on the same doc; serve_lookup,
        serve_order and serve_counts each launched, their launches
        summing to the tier's `serve.dispatches`, and the bulk kernels
        launched once per slab;
     e. the multi-device slice (parallel/), on 4 virtual ranks of this
        card, meshes (4, 1) and (2, 2), each answer equal to the
        single-device answer on the card: `sharded_full` of the bulk slab
        (full and lean, one materialize_wire launch a rank) byte-equal to
        `run_batch_full`; `step` over the
        multi-actor batch (lanes, and the union equal to the host twin of
        the scatter union); `sharded_clock_union` and `sharded_dominated`
        at BASELINE config 5 equal to `union_reduce` and `gte`; the
        product route, a `Repo` on phase d's corpus with
        `visible_devices()` replaced by the 4 ranks (slabs of 512 docs),
        `open_many` + `fetch_bulk_summaries` serially (HM_PIPELINE=0)
        with `sharded_slabs >= 1`, and pipelined (HM_PIPELINE=1: whole
        slabs round-robin over the ranks) with `rr_slabs >= 1`, every
        summary of both byte-equal to phase d's single-device Repo; then a
        `MeshBulkScheduler` dispatching the product's slabs, whose
        `collective_clock_union` and `gather_summaries` equal the
        per-slab fetches; each wall printed. With two or more cards the
        same phase runs on min(count, 4) peer ranks; with one it prints
        that peer ranks were not run;
     f. the live slice (backend/live.py): bench.py `_config6_text_trace`'s
        doc (one author, one op per change, 259,778 ops) written with its
        sidecar by `make_corpus`, opened lazily through `open_many`, then
        `_config6_live_burst`'s traffic through `apply_remote_changes` —
        a peer's first edit (adoption included), then 256 edits in chunks
        of 32, each tick at D = 1, N = 262144 on the card; then 8 docs of
        16,384 ops, each sent a 128-op chunk inside one raised tick window
        (one dispatch at D = 8, N = 32768). Each burst runs again on a
        copy of its directory with HM_DEVICE_MIN_CELLS above the bucket
        (the engine's numpy twin route): every doc's snapshot patch,
        clock, history length and frontend value identical; one captured
        tick batch equal to the plain version on the CPU; the engine's
        stats and the first-edit latency and burst rate printed;
     g. the pipelined cold open (backend/pipeline.py) at bench.py's
        primary shape: `make_corpus` writes 10,240 docs x 1,024 ops once
        (no .sig, as in d); slabs of 4,096 (two whole, a ragged third);
        fresh copies of it (a copy of its database, its feed files
        hard-linked, as the bench's `coldopen` makes them: an open
        writes only the database)
        opened by `Repo(path)` + `open_many` + `fetch_bulk_summaries`
        under three routes — (a) HM_PIPELINE=0, (b) HM_PIPELINE=1 with
        the device pack (the default), (c) HM_PIPELINE=1 HM_DEVICE_PACK=0
        (the native host pack) — once each (no profiled open: the
        bench's `coldopen` cell traces route b); every open's summaries
        byte-equal to the first;
        launch counts set to 0 before each open and read after:
        pack_prefix once a slab on a and b and never on c,
        materialize_wire once a slab on every route, `host_args` on c
        alone; the `pipeline` stat 1 on b and c; each open's wall,
        `wall_critical_path`, stage busy times, pack pool lanes,
        and `os.cpu_count()` printed;
     h. the crash slice (storage/wal.py, storage/scrub.py, the backend's
        open), bench.py `_config_crash` with the port in both processes:
        (a) a child process runs the port's `Repo(path)` under HM_FSYNC=1
        (the journal on, as by default), creates a doc and appends edits,
        printing each ack after the durability flusher settled, and is
        killed with SIGKILL after 150 acks; (b) `Repo(path)` on the card,
        timed until the doc reads (`t_recover_ms`): recovery ran, its
        report was persisted (`last_report`), the doc holds a gapless
        prefix covering every ack (`acked_lost` 0), and the repo takes a
        write; (c) the same kill inside a copy (never hard links) of
        phase d's corpus, reopened on the card: the journal's ledger
        bounds the scan (`feeds_skipped` at least the corpus's feeds
        less the writer's dirty ones), then `open_many` +
        `fetch_bulk_summaries` of the 2,048 docs on the pipelined
        default route, launch counts set to 0 before the open and read
        after it (pack_prefix and materialize_wire once a slab), every
        summary byte-equal to phase d's open before the kill, and the
        own clock store's `union_query` / `dominated_query` through the
        mirror on the card (clock_union, clock_pair) equal to numpy over
        the sqlite rows recovery left; (d) a `CrashRecorder` over a port
        workload at HM_FSYNC=1, three prefixes materialized under
        `powercut=True` and each reopened on the card: the journal
        replays (`storage.wal.replayed` above 0) and `acked_lost` is 0;
        each part's numbers printed with the card's name and power limit,
        and a `crash` JSON line;
     i. the network slice (net/, the backend's network hooks,
        `Repo.set_swarm`): (a) BASELINE configs[1] as bench.py's
        `_config2_convergence` sends it — two `Repo(memory=True)` on the
        card, each with a `TcpSwarm()` (encrypted and authenticated, the
        defaults), B dialing A, 10 docs created on A and opened on B, 50
        rounds of appends on A and every fifth round on B, then a paste on
        A (one change a doc appending 16 edits, so that B ticks more than
        8 ops whatever the delivery timing) — once at the engine's
        defaults and once with the live cutovers at 0 and a 500 ms tick
        (B's ticks of more than 8 ops on the card): every doc on B holds
        all 76 edits and equals A's, each side's values equal
        the plain replay of the changes it holds (bench_torch/reference.py
        `replay_value`), each connection's proven
        identity is the other repo, materialize_live launched on the
        second run; wall time, both sides' live-engine stats, the
        replication and wire counters and the transport crypto (native
        libsodium or chacha) printed; (b) a late replica: A holds a signed
        corpus of 32 docs x 1,024 ops (phase d's shape, cut in docs: the
        pure-Python crypto) in `Repo(path)` and opens it; B, a fresh
        `Repo(path)` on the card over TcpSwarm, `open_many`s every url
        and replication pulls every feed in signed chunks; B closed and
        reopened, `open_many` + `fetch_bulk_summaries` with launch counts
        set to 0 before and read after (pack_prefix and materialize_wire
        launched), every summary byte-equal to A's open; the pull's and
        the reopen's times printed; a `net` JSON line;
     j. churn (net/faults.py, net/aio.py, net/discovery/), under 3i's
        live cutovers: (a) bench.py `_config_churn` uncut, two card repos
        over TcpSwarm with B's swarm a seeded FaultSwarm killed and healed
        twice in the burst, on the thread stack and on the shared loop
        (HM_NET_ASYNC=1); (b) the same on the loop under HM_FAULT; (c)
        bench.py `_config_swarm` cut to 10 card repos (from 16) joined
        through one DHT node; every value equal on all sides and to the
        plain replay,
        materialize_live launched; a `chaos` JSON line;
     k. the hub (net/ipc.py), every process a port process: the daemon
        `python -m hypermerge_tpu_torch.net.ipc <repo> <sock> --hub` on
        the card by default, with HM_WORKERS=2 worker daemons and
        durable acks (HM_FSYNC=1, HM_ACK_DURABLE=1, HM_WAL_MS=30: bench.py
        `_writer_daemon_env`); (a) bench.py `_config_writers` at 8
        writers: 8 writer processes on `connect_frontend`, each making
        200 ack-paced edits to its own doc and then a paste of 16 keys;
        a fresh observer connection reads every doc equal to its
        writer's sequence; the hub's merged telemetry (`workers.<i>.*`,
        the summed journal appends and live-engine counters); the daemon
        stopped and restarted over the same repo (HM_WAL_MS=3,
        HM_WORKER_RESPAWN_MS=100, for (b)), and one `open_many` of every
        doc through it, which each worker opens as a bulk load on the
        card; (b) on that daemon, bench.py `_config_writers_hotdoc` (8
        writers x 60 edits on one doc, every digest bit-identical), then
        tests/test_wal.py's worker kill: the doc's worker SIGKILLed after
        8 observer-acked edits, respawned, a new connection reads every
        acked edit (acked_lost 0) and writes; the time to respawn and to
        the first read; then each shard repo opened here by
        `Repo(path)`, `open_many` + `fetch_bulk_summaries` with the
        launch counts set to 0 just before and read just after
        (pack_prefix and materialize_wire launched), every value equal
        to the observer's; each worker's /proc/<pid>/cmdline names the
        port's module and the device, and its maps show libcuda (and,
        after the restarted daemon's open, the built pack_prefix and
        doc_kernel libraries); a `hub` JSON line;
     l. the service plane (serve/overload.py): (a) a `Repo(path)` on a
        copy of 3d's corpus under durable acks, `open_many` +
        `fetch_bulk_summaries` (pack_prefix, materialize_wire), then
        `{kind: len}` reads with the ladder pinned by HM_SERVICE_FORCE
        (the controller rebuilt for each part as the backend builds it):
        (i) healthy, 32 hot docs and 64 cold ones installed,
        serve_counts launches equal to serve.dispatches; (ii) brownout,
        64 more cold docs read one at a time from the host path, each
        install deferred (service.deferred_installs and brownout_reads
        64, the residency unchanged), hot reads still on serve_counts,
        every answer equal to (i)'s or to host_read; (iii) shed with
        quotas of 64 reads/s and a burst of 16, two tenants: each
        tenant's admitted reads at most burst + rate x wall, every other
        read a typed Overload with retry_after_s >= 0.1, service.
        shed_reads equal to the refusals seen and to the report's
        per-tenant sum, and a durable edit's ack at least
        HM_SERVICE_ACK_STRETCH_MS later (median of 16) than under (i);
        (iv) unforced at a 1 ms p99 SLO and 25 ms ticks, 8 reader
        threads: the ladder climbs healthy -> brownout -> shed on the
        tier's own p99 from the card, and steps back to healthy within
        2 x HM_BROWNOUT_DOWN_TICKS idle ticks of the readers' stop;
        (b) bench.py `_config_service` at its defaults (4 client
        processes on `connect_frontend` running bench.py's
        `_SERVICE_CHILD`, 48 docs, a ramp of 1 s rounds to 16 threads a
        client, a 3 s storm at twice saturation with durable writers,
        recovery probes, SLO 25 ms, quotas 64/16) against the daemon
        `python -m hypermerge_tpu_torch.net.ipc <repo> <sock> --hub
        --dht --dht-bootstrap ...` on the card (HM_WORKERS=0), with a
        card `Repo` replicating through the DHT here: its five gates
        (reads_never_error, acked_lost_zero, recovery_within_gate,
        shed_order_ok, attributed) must hold, and the daemon's maps show
        libcuda and the built serve_counts library; a `service` JSON
        line;
     m. hyperfiles (files/): two `Repo(path)` on the card, each on a
        `TcpSwarm()`, B dialing A. A writes a hyperfile at each of 0, 1,
        62 KiB - 1, 62 KiB, 62 KiB + 1 and 1 MiB bytes (seeded; every
        other one as odd-sized chunks) and a doc naming each; B opens
        each doc, reads the url from it and fetches the file with
        progress events (bytes, header and blocks == A's). B is closed
        and reopened on the card: `open_many` + `fetch_bulk_summaries`
        of the docs with the launch counts set to 0 just before and read
        just after (pack_prefix and materialize_wire must launch), every
        doc == A's, no file feed in the sidecar slab or among the actors,
        every file read back from B's disk. Then B's file server on a
        unix socket: each file over HTTP, a 1 MiB file A writes after the
        reopen fetched through the server from the swarm under
        HM_FILE_FETCH_TIMEOUT_S=120 (printed), an upload through
        `repo.files.write` read back and in `meta.files`, an unknown id
        answered 404 with no feed left; a `files` JSON line with the
        transport crypto and the signing route;
     phase 3n: the concurrency analysis — a child process with
     HM_LOCKDEP=1 and HM_RACEDEP=1 set before any import (every lock a
     DepLock, every field of the guard map instrumented): (a) a seeded
     AB/BA order and a seeded unguarded write, both reported; (b) phase
     3d's bulk open on a copy of its corpus and 2,000 `len` reads from 8
     threads through the batcher; (c) a 128-op burst into each of 2
     bulk-opened docs of 8,192 ops in one [2, 16384] tick, the
     many-block route; (d) 3i (a)'s config 2 at its defaults; (b) and (c)
     held to the same paths run uninstrumented just before on copies, (d)
     to the plain replay; no finding, no time blocked under
     `live.engine`, the kernel locks and `live.engine`, `doc.emit`,
     `serve.cache` taken, pack_prefix, materialize_wire, serve_counts
     and materialize_live launched, 3n within 90 s; a `lockdep` JSON line
     (classes, edges, findings, racedep's fields, the blocking debt by
     class, launches, the open's wall against its uninstrumented wall);
     phase 3o: the command-line tools (`python -m
     hypermerge_tpu_torch.tools.<name>`) on 3n's plain copy of 3d's
     corpus: (a) `meta --stats` through its `main` here, the launch
     counts set to 0 just before and read just after (pack_prefix and
     materialize_wire once a slab); (b) `meta --stats` as a process of
     its own on the card (`slab.h2d_bytes` > 0); (c) `ls` (every doc's
     url, its scrub= verdict, wal=clean); (d) `cat` and `watch --once`
     of four docs, each equal to bench_torch/reference.py's replay of
     the doc; (e) `cp` of a seeded 1 MiB file in and `cat` of it out,
     byte-equal, `meta` of its url; (f) `serve --ipc` as a process on
     the card: 8 threads x 250 `len` Read queries over its socket, each
     equal to the replay, `top --sock --once --json` (serve.reads > 0),
     the daemon's maps (libcuda, the built serve_counts library), its
     exit on SIGINT; (g) `scrub --dry-run --json` on a copy with a
     seeded crash marker, whose bytes it keeps; a `tools` JSON line
     (each tool's wall, exit code, the launches read); 3o within 60 s;
     phase 3p: the main path's reference cases (tests/test_device_
     materialize.py, test_summary_wire.py, test_clock.py,
     test_clock_mirror.py, test_pipeline.py, test_parallel.py,
     test_live_demote.py) at their own sizes with device="cuda", each
     part's launch counts set to 0 just before and read just after, a
     part whose kernels did not launch failing: (a) the fuzz seeds 1-5,
     the causal-sort and host-kernel batches through doc_kernel.cu's
     many-block route and its one-block slab launch with the wire, each
     lane == run_batch_host == plain, the decoded doc == the host OpSet;
     (b) the wire case through summary_wire.cu, full and lean, and the
     slab launch's wire; (c) the clock infinity cases (clock_pair,
     clock_topk) and the mirror's clamp (clock_scatter, clock_union) ==
     a CPU mirror; (d) the pipeline fuzz as card Repos, HM_PIPELINE=1 ==
     =0 (pack_prefix, the slab's one launch); (e) the mesh reductions
     fuzz on 8 virtual ranks, every fold's ring in the flagged launch's
     protocol mode (ring_gather, clock_union's min mode); (f) the demote
     twin on a card Repo under HM_LIVE_MAX_BYTES, closed by a 16-op
     paste whose tick takes the kernel (materialize_live), HM_LIVE=1 ==
     =0 in both delivery orders; a `twins` JSON line; 3p within 45 s;
  4. time each kernel (CUDA events, median of 7 runs after warm-up) beside
     its plain version, its bound and, where one PyTorch call computes
     the same function, that call (torch.argsort for the sort in the
     summary wire, also at the long doc; for the slab's one launch also
     its lean wire, its kernel alone and cold, its host work, kernels 1
     and 2 launched apart, and the device memory one call allocates;
     torch.amax, scatter_reduce_ and torch.topk for the
     clock kernels, whose device time alone torch.profiler also
     reads, top-k's two kernels apart; torch.sort for serve_order;
     torch.amin for the min mode at the pmin's [2, 50000];
     for clock_scatter, serve_order, serve_counts and the min mode also
     the wrapper's host work, the
     kernel alone cold (`cold_calls_ms`: each call on inputs of its own
     after the L2 is flushed), the scatter's device-triple route and its
     kernel beside the parameter route, config 5's flush through
     `_scatter_pending` beside an upload + scatter_reduce_ (`flush_ms`),
     serve_order's and serve_counts' copy back alone and their
     like-for-like library dispatches (key, stable torch.sort, one copy
     to the host; masks, two sums, one cat, one copy to the host);
     torch.cat for the ring gather, whose kernel alone is read with cold
     inputs and outputs and must not be under its bound, with the
     flagged launch over the same ranks, timed at the summary gather's
     shape of phase 3e and at n = 4, 4096 x 1540); clock_pair at the
     config-5 matrix through the main path's entry, gte_host (the query
     by value, the verdicts through the pinned buffer), and through its
     device route (pair_cuda), the host work of each, the kernel alone
     warm and cold (`cold_kernel_ms` over copies of the matrix), the
     two-call torch.all(m <= q) and mirror.dominated's wall; pack_prefix at the
     slab (its bound from the planes it reads and the planes, flags,
     slot and ranges it writes; the wrapper, its host work, the kernel
     alone warm and with the L2 flushed before each call), at the ragged
     slab and at the 65,536-row doc; time the pack's host stages
     (marshal into the staging buffer, native and numpy, its one copy
     up, the emit, the whole pack) beside the host route's (the native
     emit alone, the whole host pack) and profile the sidecar slab (pack + dispatch + fetch:
     device time by kernel, idle share, the copies in each direction
     with their count, bytes and ms),
     config 5's hot query (1,000 writes + union(), host buffering
     included), and print the read mix's QPS, its p50 and p99 from the
     raw per-read latencies (and the `serve.read_s` histogram's bucket
     bounds), the host twin's QPS, p50 and p99 on the same 4,000 reads,
     and the profiled window's device busy time and idle share; time the
     live tick's kernel at [1, 262144] and [8, 32768] (its kernels alone
     summed over every launch of the many-block route, their count, the
     entry alone cold, its host work, and the one-block route forced on
     the same inputs) beside its plain version, the engine's numpy twin
     on the same docs and its bound; serve_lookup's host work, copy
     back, cold kernel and like-for-like library dispatch (stack, three
     compares, argmax, any, one copy to the host); doc_kernel.cu's routes
     forced (one block a doc with its scratch in shared memory, the same
     in global lanes, the many-block route), byte-equal, then timed in
     turn (wrapper and kernels alone) at the bulk shapes (the slab, a rank's share of it and of
     the product route's slab, the multi-actor batch and a rank's share,
     2,048 short docs), over a grid of D in 1 .. 512 x N in 1,024 ..
     65,536 and at phase 2's live ticks, beside the route the entry
     picks;
     print the bytes bound of each phase-3e mesh program; print the
     kernels as one JSON line; profile one slab dispatch of each
     slice for its device time by kernel and the device's idle share (a
     profiler reading that gets no device record is printed as not
     measured, None: the profiler is a reading, not a check);
  5. print {"ok": true, "device": {...}} as the last line.

It exits non-zero with no result when no GPU is present, and when the
port's package is not beside it.

    python3 chip_smoke.py --ab OTHER [ROUNDS]

holds the slab's device program of this tree against another tree of the
port (OTHER, e.g. its parent unpacked by `git archive`) on the same card:
ROUNDS (default 1) times OTHER, this tree, this tree, OTHER, each a
process of its own that builds its tree's kernels and prints one JSON
line (`slab_numbers`, through entries every tree of the port has: the
slab program, the wire, the sidecar slab's wall, pack and pack_prefix
with its profile and copies, phase 3d's and phase 3g's opens on shared
corpora, clock_pair at config 5 (wrapper, host, alone warm and cold,
bound, plain, two-call) and the mirror's dominated wall, the live tick),
then the card's name and power limit.

    python3 chip_smoke.py --lockdep

runs phase 3n alone (the kernels built and phase 3d's corpus written
first).

    python3 chip_smoke.py --tools

runs phase 3o alone (the kernels built and phase 3d's corpus written
first).

    python3 chip_smoke.py --twins

runs phase 3p alone (the kernels built first).

    python3 chip_smoke.py --storm N

runs phase 3l (b) N times as the script runs it, then N times with a
side connection that asks the hub for its telemetry every 0.2 s (a load
on the hub's one GIL, as a monitoring tool would add), one `storm` JSON
line a run (the recovery probes, each [seconds after the storm, reads,
shed, p99 ms], the steady round, the gates); first the times of the
pure-Python ChaCha20-Poly1305 (`utils/chacha.py`, the transport's route
where libsodium is missing) at 100 B to 1 MiB, then the card's name and
power limit.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

MEM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
L2_BYTES = 50 * 2**20  # H100 SXM L2
# the card's spin per queued call in cold_kernel_ms, longer than a
# wrapper's host work (0.2 ms at ~2 GHz), so the calls run back to back
COLD_SLACK_CYCLES = 400_000
NVLINK_BYTES_PER_S = 450e9  # H100 SXM NVLink, each way (900 GB/s both)
SCALAR_OPS_PER_S = 67e12  # H100 SXM fp32 outside the tensor cores; the
# published table has no int32 rate, and these kernels do int32 work
SLAB = dict(n_docs=4096, n_ops=1024, n_actors=1)
MULTI = dict(n_docs=1024, n_ops=512, n_actors=3, text_frac=0.5)
TEMPLATES = 8  # distinct template feeds behind the sidecar slab
INF = float("inf")
# the slab's one launch (doc_kernel.cu's one-block route with the summary
# wire as its epilogue); kernel 1 alone (run_batch); kernel 1's many-block
# route and the standalone wire (a long doc's slab)
SLICE1 = ("materialize_wire", "materialize", "summary_wire")
SLICE2 = ("pack_prefix", "materialize_wire")
# a bulk slab of one long doc, which takes the many-block route: kernel 1
# and then summary_wire.cu (its sort keys in global scratch)
LONG_DOC = dict(n_docs=1, n_ops=60_000, n_actors=1, text_frac=0.99)
# BASELINE config 5 (bench.py _config5_union): the mirror's size
CONFIG5 = dict(n_docs=100_000, n_actors=64, dirty=1000)
CLOCKS = ("clock_scatter", "clock_union", "clock_pair", "clock_topk")
STORE = dict(n_docs=2000, n_actors=16, steps=600, seed=5)
# bench.py _config_read: the serving configuration and its read mix
READ = dict(n_docs=2048, n_ops=1024, hot=32, readers=8, reads=4000,
            seed=0xEAD5)
SERVE = ("serve_lookup", "serve_order", "serve_counts")
BULK = ("pack_prefix", "materialize_wire")
# the multi-device slice: ring shapes of phase 2 (n ranks, rows, W bytes;
# 708 and 1540 are the lean wires at N = 512 and N = 1024), the mesh of
# phase 3e and the product route's slab (four slabs of phase 3d's corpus)
RING_N = (2, 3, 4, 8)
RING_ROWS = (1, 7, 1024, 4096)
RING_W = (1, 3, 708, 1540, 4096)
# runs of the CUDA-event medians of calls whose time is mostly the host's
# (top-k and the ring gather, their plain and library yardsticks): the
# host clock spreads more than the card's
HOST_BOUND_RUNS = 25
# the subset that also runs the flagged launch over virtual ranks
RING_PROTOCOL_ROWS = (1, 1024)
RING_PROTOCOL_W = (3, 1540)
MESH_RANKS = 4
MESH_SLAB = 512
MESH = ("ring_gather", "clock_union_min")
LANES = ("visible", "map_winner", "elem_winner", "elem_live", "rank",
         "inc_total", "clock")
# the live slice (phase 3f): bench.py _config6_text_trace's doc (the
# automerge-perf trace's size) under _config6_live_burst's traffic (a
# first edit, then 256 in chunks of 32), and 8 docs of 16,384 ops each
# sent a 128-op chunk in one tick window
LIVE_TRACE = dict(n_docs=1, n_ops=259_778, ops_per_change=1, text_frac=1.0,
                  seed=3, edits=256, chunk=32, tick_ms=None, bucket=262144)
LIVE_GROUP = dict(n_docs=8, n_ops=16_384, ops_per_change=16, text_frac=0.85,
                  seed=0, edits=128, chunk=128, tick_ms=3000, bucket=32768)
# the pipelined cold open (phase 3g): bench.py's primary shape, 10,240 docs
# x 1,024 ops in slabs of 4,096 (two whole slabs and a ragged third), under
# three routes, one open each: (a) the serial twin, (b) the streaming
# pipeline with the device pack (the port's default), (c) the pipeline with
# the native host pack (no profiled open: the bench's `coldopen` cell traces
# route b)
BENCH_OPEN = dict(n_docs=10240, n_ops=1024, slab=4096)
OPEN_ROUTES = {
    "a": dict(HM_PIPELINE="0", HM_DEVICE_PACK="1"),
    "b": dict(HM_PIPELINE="1", HM_DEVICE_PACK="1"),
    "c": dict(HM_PIPELINE="1", HM_DEVICE_PACK="0"),
}
OPEN_STATS = ("wall_critical_path", "t_sql", "t_io", "t_spec", "t_pack",
              "t_dispatch", "t_fetch", "t_fetch_busy", "pack_workers",
              "t_pack_busy_per_worker", "t_pack_wall")
# readings that a kernel's entry in the `kernels` line carries beside the
# contract's keys, where phase 4 took them
EXTRA_READINGS = ("host_ms", "kernel_ms", "cold_kernel_ms", "device_route_ms",
                  "device_route_kernel_ms", "flush_ms", "flush_library_ms",
                  "copy_back_ms", "library_dispatch_ms", "kernels_per_call",
                  "one_block_ms", "lean_ms", "two_launch_ms", "peak_mb",
                  "long_doc_ms", "long_doc_library_ms",
                  "device_route_host_ms", "dominated_wall_ms",
                  "dominated_query_row_ms", "dominated_scan_ms",
                  "dominated_listing_ms")
# every kernel of doc_kernel.cu: the one-block route's, then the many-block
# route's (one dispatch launches either the first or all the others)
DOC_KERNELS = ("materialize_kernel", "mb_init_kernel", "mb_supersede_kernel",
               "mb_rows_kernel", "mb_winners_kernel", "mb_tile_kernel",
               "mb_stage_kernel", "mb_map_ends_kernel",
               "mb_sibling_keys_kernel", "mb_sibling_ends_kernel",
               "mb_climb_kernel", "mb_rank_init_kernel", "mb_rank_kernel")
# torch.profiler now and then delivers no device record for a window; a
# kernel-alone window is tried again, and every window is padded with idle
# host time so that device records near its edges fall inside it
PROFILE_TRIES = 3
PROFILE_PAD_S = 0.005


def log(*a) -> None:
    print(*a, flush=True)


@contextlib.contextmanager
def env_vars(**values):
    """Environment variables set for the block, restored after it."""
    saved = {k: os.environ.get(k) for k in values}
    os.environ.update({k: str(v) for k, v in values.items()})
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def toolkit_line() -> str:
    """The nvcc release that builds the kernels (its parameter limit: 4 KB,
    or 32,764 bytes from CUDA 12.1), the driver's version, and torch's."""
    import torch
    from hypermerge_tpu_torch.kernels import _build

    nvcc = subprocess.run([_build.nvcc_path(), "--version"],
                          capture_output=True, text=True, check=True, timeout=60)
    release = [ln for ln in nvcc.stdout.splitlines() if "release" in ln]
    drv = subprocess.run(
        ["nvidia-smi", "--query-gpu=driver_version", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return (f"toolkit: nvcc {release[0].strip() if release else '?'}; driver "
            f"{drv.stdout.strip().splitlines()[0]}; torch {torch.__version__} "
            f"(CUDA {torch.version.cuda})")


def make_batch(synth, cfg):
    cfg = dict(cfg)
    return synth.synth_batch(cfg.pop("n_docs"), cfg.pop("n_ops"), **cfg)


def cuda_args(ck, batch, lean=False):
    import torch

    np_args, A, K = ck.host_args(batch, lean=lean)
    args = tuple(
        None if a is None else torch.from_numpy(a).cuda() for a in np_args
    )
    return args, A, K


def max_abs_err(a, b) -> int:
    return int((a.long() - b.long()).abs().max().item()) if a.numel() else 0


def compare_kernels(ck, batch, name):
    """Kernel vs plain on the card, same inputs: kernel 1 alone, the
    slab's one launch (kernel 1 with the wire as its epilogue) with the
    doc's scratch in shared memory and in global lanes, and the standalone
    wire (its sort keys in shared memory up to the source's cap of rows,
    in global scratch above: the long doc's); full and lean. Returns the
    max abs err per kernel and raises on any difference."""
    import torch

    errs = {"materialize": 0, "summary_wire": 0, "materialize_wire": 0}
    N = batch.n_rows
    one_block = (ck.DOC_ROUTE_ONE_BLOCK, ck.DOC_ROUTE_ONE_BLOCK_GLOBAL)

    def held(kernel, label, got, want):
        torch.cuda.synchronize()
        errs[kernel] = max(errs[kernel], max_abs_err(got, want))
        if not torch.equal(got, want):
            raise AssertionError(f"{name} {label} differs")

    for lean in (False, True):
        args, A, K = cuda_args(ck, batch, lean=lean)
        want = ck.doc_kernel_plain(
            *ck.widen_plain(*args[:10]), args[10], A=A, K=K
        )
        wire_plain = ck.summarize_wire_plain(want, N, A, lean)
        got = ck.materialize_cuda(*args, A=A, K=K)
        for f in want._fields:
            held("materialize", f"lean={lean}: lane {f}", getattr(got, f),
                 getattr(want, f))
        for route in one_block:
            got, wire = ck.materialize_wire_cuda(*args, A=A, K=K, lean=lean,
                                                 route=route)
            for f in want._fields:
                held("materialize_wire", f"route {route} lean={lean}: lane "
                     f"{f}", getattr(got, f), getattr(want, f))
            held("materialize_wire", f"route {route} lean={lean}: wire",
                 wire, wire_plain)
        held("summary_wire", f"lean={lean}: wire",
             ck.summary_wire_cuda(want, N, A, lean), wire_plain)
    keys = "shared" if N <= ck.launch_cap("summary_wire") else "global"
    log(f"phase 2 {name} {batch.shape}: kernels == plain (exact): kernel 1, "
        f"the one launch with its wire on routes {one_block}, the wire "
        f"alone with its keys in {keys} memory")
    return errs


def check_summary(arrays, dec, decode_columnar, lean):
    import numpy as np

    ref = decode_columnar(dec)
    for k, v in ref.items():
        if lean and k == "clock":
            continue
        if not np.array_equal(np.asarray(v), np.asarray(arrays[k])):
            raise AssertionError(f"summary {k} differs from its host decode")


def main_path(ck, mat, synth, columnar, slab, long_doc):
    """The first slice's entries as a user calls them; returns its launch
    counts."""
    import numpy as np
    import torch

    for k in ck.launches:
        ck.launches[k] = 0
    t0 = time.perf_counter()
    # the bulk slab dispatch (full and lean) + host decode, then the slab
    # of one long doc (the many-block route and the standalone wire)
    for batch, lean in ((slab, False), (slab, True), (long_doc, False)):
        out, wire = ck.run_batch_full(batch, lean=lean)
        arrays = mat.fetch_summary(wire, batch, lean=lean)
        check_summary(arrays, mat.DecodedBatch(batch, out),
                      mat.decode_columnar, lean)
        if arrays["elem_order"].shape != batch.shape:
            raise AssertionError("elem_order shape")
    # a pack of distinct histories, end to end, against the CPU path
    hists = [
        synth.synth_changes(512, n_actors=3, text_frac=0.5, seed=1000 + i)
        for i in range(64)
    ]
    docs = mat.materialize_docs(mat.materialize_batch(hists))
    docs_cpu = mat.materialize_docs(mat.materialize_batch(hists, device="cpu"))
    if docs != docs_cpu:
        raise AssertionError("materialize_docs: GPU != CPU")
    batch = columnar.pack_docs(hists)
    summ = mat.summarize_columnar(batch)
    summ_cpu = mat.summarize_columnar(batch, device="cpu")
    for k in summ_cpu:
        if not np.array_equal(summ[k], summ_cpu[k]):
            raise AssertionError(f"summarize_columnar {k}: GPU != CPU")
    torch.cuda.synchronize()
    counts = dict(ck.launches)
    log(f"phase 3a first slice: {time.perf_counter() - t0:.3f} s wall, "
        f"launches {counts}")
    for k in SLICE1:
        if counts[k] == 0:
            raise AssertionError(f"kernel {k} never launched on the main path")
    return counts


def median_ms(fn, runs=7, warmup=2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def host_call_ms(fn, runs=50, warmup=5) -> float:
    """Median host time of one call of fn, without waiting for the card:
    a wrapper's checks, allocations and launches."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
    return statistics.median(times)


def peak_mb(fn) -> float:
    """MiB of device memory one call of fn allocates at its peak, beyond
    what was allocated before it."""
    import torch

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    kept = fn()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    del kept
    return peak / 2**20


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def time_kernels(ck, batch, long_doc=None):
    """{kernel: numbers} at this batch's shape; with `long_doc`, the
    standalone wire also at that batch's shape (its keys in global
    scratch)."""
    import torch

    args, A, K = cuda_args(ck, batch)
    flags, slot, ctr, seq, obj, key, ref, value, psrc, ptgt, da = args
    D, N = batch.shape
    plain_args = ck.widen_plain(*args[:10]) + (da,)
    out = ck.materialize_cuda(*args, A=A, K=K)
    rounds = max(1, math.ceil(math.log2(max(N, 2)))) + 1
    log2n = max(1, int(math.log2(N)))
    res = {}

    # kernel 1: reads flags..value + ptgt once (as the link narrows them),
    # writes 5 bool + 2 int32 lanes + the clock; ops: two comparison sorts
    # (N log2 N each) and the doubling + ranking rounds (1 + 3 int ops per
    # row per round)
    lanes_in = nbytes(flags, slot, ctr, seq, obj, key, ref, value, ptgt)
    b1 = lanes_in + nbytes(*out)
    o1 = D * (2 * N * log2n + 4 * (N + 1) * rounds)
    res["materialize"] = dict(
        ms=median_ms(lambda: ck.materialize_cuda(*args, A=A, K=K)),
        plain_ms=median_ms(lambda: ck.doc_kernel_plain(*plain_args, A=A, K=K)),
        library_ms=None, bytes=b1, ops=o1,
    )

    # kernel 2 alone: reads two masks + rank + clock, writes the wire; ops:
    # one comparison sort (N log2 N)
    wire = ck.summary_wire_cuda(out, N, A, False)
    b2 = nbytes(out.map_winner, out.elem_live, out.rank, out.clock, wire)
    o2 = D * N * log2n
    order_key = torch.where(out.elem_live, -out.rank, 2**31 - 1)
    res["summary_wire"] = dict(
        ms=median_ms(lambda: ck.summary_wire_cuda(out, N, A, False)),
        plain_ms=median_ms(lambda: ck.summarize_wire_plain(out, N, A, False)),
        library_ms=median_ms(
            lambda: torch.argsort(order_key, dim=1, stable=True)
        ),
        bytes=b2, ops=o2,
    )
    if long_doc is not None:
        la, lA, lK = cuda_args(ck, long_doc)
        lN = long_doc.n_rows
        lout = ck.materialize_cuda(*la, A=lA, K=lK)
        lkey = torch.where(lout.elem_live, -lout.rank, 2**31 - 1)
        res["summary_wire"].update(
            long_doc_ms=median_ms(
                lambda: ck.summary_wire_cuda(lout, lN, lA, False)),
            long_doc_library_ms=median_ms(
                lambda: torch.argsort(lkey, dim=1, stable=True)),
        )
        log(f"timing summary_wire long doc {list(long_doc.shape)} (keys in "
            f"global scratch): ms={res['summary_wire']['long_doc_ms']!r} "
            f"argsort_ms={res['summary_wire']['long_doc_library_ms']!r}")

    # the slab's one launch: kernel 1 with the wire as its epilogue. Bytes:
    # the narrow lanes read once, the lanes and the wire written once (no
    # re-read); ops: kernels 1 and 2's
    def fused(a=args, lean=False):
        return ck.materialize_wire_cuda(*a, A=A, K=K, lean=lean)

    lean_args = cuda_args(ck, batch, lean=True)[0]
    copies = [tuple(None if x is None else x.clone() for x in args)
              for _ in range(max(2, math.ceil(4 * L2_BYTES / b1)))]

    def two_launch():
        o = ck.materialize_cuda(*args, A=A, K=K)
        return o, ck.summary_wire_cuda(o, N, A, False)

    f_out, f_wire = fused()
    res["materialize_wire"] = dict(
        ms=median_ms(fused),
        lean_ms=median_ms(lambda: fused(lean_args, True)),
        host_ms=host_call_ms(fused),
        kernel_ms=kernel_device_ms(fused, "materialize_kernel"),
        cold_kernel_ms=cold_kernel_ms(
            lambda i: lambda: fused(copies[i % len(copies)]),
            lanes_in + nbytes(*f_out) + nbytes(f_wire)),
        two_launch_ms=median_ms(two_launch),
        peak_mb=peak_mb(fused),
        plain_ms=median_ms(lambda: ck.summarize_wire_plain(
            ck.doc_kernel_plain(*plain_args, A=A, K=K), N, A, False)),
        library_ms=None,
        bytes=lanes_in + nbytes(*f_out) + nbytes(f_wire), ops=o1 + o2,
    )
    del copies
    for r in res.values():
        t_bytes = r["bytes"] / MEM_BYTES_PER_S * 1e3
        t_ops = r["ops"] / SCALAR_OPS_PER_S * 1e3
        r["bound_ms"] = max(t_bytes, t_ops)
        r["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    return res


def profile_dispatch(label, fn) -> dict:
    """Device time by kernel for one call of fn (a slab dispatch or a
    read window, host stages included), from torch.profiler; returns the
    wall, the device's busy time, its idle share and the window's copies
    by direction (count, bytes, ms: the trace's memcpy records)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    for attempt in range(1, PROFILE_TRIES + 1):
        with profile(activities=acts) as prof:
            time.sleep(PROFILE_PAD_S)
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
            time.sleep(PROFILE_PAD_S)
        rows = sorted(prof.key_averages(), key=dev_us, reverse=True)
        # busy = device-side events only (kernels, copies); a CPU op such
        # as aten::copy_ also carries the device time of the work it
        # launched
        busy_ms = sum(
            dev_us(e) for e in rows
            if getattr(e, "device_type", None)
            == torch.autograd.DeviceType.CUDA
        ) / 1e3
        if busy_ms > 0:
            break
        log(f"profile {label}: no device record (window {attempt} of "
            f"{PROFILE_TRIES})")
    copies = trace_copies(prof)
    log(f"profile {label}: copies {json.dumps(copies)}")
    if busy_ms <= 0:
        # the window's work ran (fn's own checks stand); only the
        # profiler's reading of it is missing
        log(f"profile {label}: wall_ms={wall_ms!r}; the profiler delivered "
            "no device record: busy time and idle share not measured")
        return dict(wall_ms=wall_ms, device_busy_ms=None,
                    device_idle_share=None, copies=copies)
    log(f"profile {label}: wall_ms={wall_ms!r} device_busy_ms="
        f"{busy_ms!r} device_idle_share={1 - busy_ms / wall_ms!r}")
    for e in rows[:8]:
        if dev_us(e) > 0:
            log(f"  {dev_us(e) / 1e3!r} ms  x{e.count}  {e.key[:70]}")
    return dict(wall_ms=wall_ms, device_busy_ms=busy_ms,
                device_idle_share=1 - busy_ms / wall_ms, copies=copies)


def trace_copies(prof) -> dict:
    """{"HtoD" / "DtoH" / "DtoD": {"count", "bytes", "ms"}} of a profiled
    window's memcpy records (its Chrome trace: each record's duration and
    its "bytes" argument; bytes None where the trace gives none)."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    finally:
        os.unlink(path)
    out = {}
    for e in events:
        name = e.get("name", "")
        if e.get("ph") != "X" or not name.startswith("Memcpy"):
            continue
        kind = next((k for k in ("HtoD", "DtoH", "DtoD") if k in name),
                    "other")
        r = out.setdefault(kind, {"count": 0, "bytes": 0, "ms": 0.0})
        r["count"] += 1
        r["ms"] += e.get("dur", 0) / 1e3
        n = e.get("args", {}).get("bytes")
        r["bytes"] = None if n is None or r["bytes"] is None else r["bytes"] + n
    return out


# -- the sidecar slice --------------------------------------------------------


def value_tail(history, port_types):
    """`history` plus changes that set root keys to values of every lane
    the pack remaps: ints outside int16, floats, bools, bigints, strings."""
    Action, Change, Op, ROOT = port_types
    last = history[-1]
    values = [2**20, -(2**20), 3.25, True, 2**40, "wide", 70000, -40000]
    out = list(history)
    start, seq = last.max_op + 1, last.seq + 1
    for i, v in enumerate(values):
        op = Op(action=Action.SET, obj=ROOT, key=f"v{i}", value=v)
        out.append(Change(actor=last.actor, seq=seq + i,
                              start_op=start + i, deps={}, ops=(op,)))
    return out


def sidecar_feeds(colcache, root, hists):
    """Each history written to its own column sidecar file under `root`,
    compacted into a v3 checkpoint, and reopened: plane-backed
    FeedColumns, as a cold open reads them."""
    fcs = []
    for t, hist in enumerate(hists):
        path = f"{root}/t{t}.cols2"
        writer = hist[0].actor
        cc = colcache.FeedColumnCache(
            colcache.FileColumnStorageV2(path), writer=writer
        )
        for c in hist:
            cc.append_change(c)
        cc.compact()
        fc = colcache.FeedColumnCache(
            colcache.FileColumnStorageV2(path), writer=writer
        ).columns()
        if fc.planes is None:
            raise AssertionError(f"{path}: no checkpoint planes after compact")
        fcs.append(fc)
    return fcs


def slab_specs(fcs, n_docs):
    return [[(fcs[d % TEMPLATES], 0, INF)] for d in range(n_docs)]


def capture(module, name, fn):
    """(fn's result, the arguments of every call of module.name during
    it)."""
    calls = []
    orig = getattr(module, name)

    def spy(*a, **k):
        calls.append((a, k))
        return orig(*a, **k)

    setattr(module, name, spy)
    try:
        return fn(), calls
    finally:
        setattr(module, name, orig)


def compare_pack(pk, columnar, specs, label, **kw):
    """Pack `specs` on the card, then hold pack_prefix against its plain
    version on the inputs the pack handed it: the 11 wire planes, flags,
    slot and the ranges (the batch's own ranges too); returns (max abs
    err, the pack_prefix keyword arguments)."""
    import torch

    batch, calls = capture(
        pk, "pack_prefix",
        lambda: columnar.pack_docs_columns(specs, device="cuda", **kw),
    )
    if len(calls) != 1:
        raise AssertionError(f"{label}: the fast pack path was not taken")
    k = calls[0][1]
    got = pk.pack_prefix_cuda(**k)
    want = pk.pack_prefix_plain(**k)
    torch.cuda.synchronize()
    err = max_abs_err(got.ranges, want.ranges)
    ranges = want.ranges.tolist()
    if got.ranges.tolist() != ranges:
        raise AssertionError(f"{label}: ranges {got.ranges} != {want.ranges}")
    if batch.ranges != dict(zip(pk.RANGES, ranges)):
        raise AssertionError(f"{label}: the batch's ranges {batch.ranges}")
    for name, a, b in zip((*columnar.COLUMNS, "flags", "slot"),
                          (*got.planes, got.flags, got.slot),
                          (*want.planes, want.flags, want.slot)):
        err = max(err, max_abs_err(a, b))
        if a.dtype != b.dtype or not torch.equal(a, b):
            raise AssertionError(f"{label}: packed lane {name} differs")
    # the host route (HM_DEVICE_PACK=0: the native hm_pack_prefix) on the
    # same specs: its planes byte-equal to the kernel's, in the wire dtypes
    with env_vars(HM_DEVICE_PACK="0", HM_NATIVE_PACK="1"):
        host, natives = capture(
            columnar, "_native_pack_prefix",
            lambda: columnar.pack_docs_columns(specs, device="cuda", **kw))
    if len(natives) != 1 or host.lanes is not None:
        raise AssertionError(f"{label}: the native host pack did not run")
    for name in columnar.COLUMNS:
        a, b = host.cols[name], batch.cols[name]
        if a.dtype != b.dtype or a.tobytes() != b.tobytes():
            raise AssertionError(f"{label}: native plane {name} != kernel's")
    log(f"phase 2 pack {label} [{k['Dp']}, {k['N']}] "
        f"M={k['planes'][0].shape[0]} row32={k['row32']}: kernel == plain "
        f"(exact: 11 planes, flags, slot, ranges {dict(zip(pk.RANGES, ranges))})"
        "; the native host pack's 11 planes == the kernel's (exact)")
    return err, k


def slice_path(ck, columnar, mat, fcs):
    """The sidecar slice's entries as a user calls them, counts set to 0
    just before and read just after; the dispatch must take the pack's
    device lanes (host_args never runs) and upload the pred edges and the
    actor map alone. Returns (batch, out, summary arrays, lean, counts)."""
    import numpy as np
    import torch

    specs = slab_specs(fcs, SLAB["n_docs"])
    host_args_calls = []
    orig_host_args = ck.host_args

    def spy_host_args(*a, **k):
        host_args_calls.append(1)
        return orig_host_args(*a, **k)

    ck.host_args = spy_host_args
    try:
        for k in ck.launches:
            ck.launches[k] = 0
        h2d0 = ck._SLAB_H2D.value()
        t0 = time.perf_counter()
        batch = columnar.pack_docs_columns(
            specs, n_docs=SLAB["n_docs"], n_rows=SLAB["n_ops"], device="cuda"
        )
        # lean as the bulk loader picks it: no INC ops (the pack's count),
        # host clocks in hand
        lean = not batch.has_inc()
        copying = batch.cols.copying
        out, wire = ck.run_batch_full(batch, lean=lean)
        arrays = mat.fetch_summary(wire, batch, lean=lean)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        uploaded = ck._SLAB_H2D.value() - h2d0
    finally:
        ck.host_args = orig_host_args
    counts = dict(ck.launches)
    da, _A, _K = ck.bucket_doc_actors(batch)
    N = batch.n_rows
    small = (ck._narrow(batch.psrc, -1, N - 1).nbytes
             + ck._narrow(batch.ptgt, -1, N - 1).nbytes
             + np.ascontiguousarray(da, np.int32).nbytes)
    log(f"phase 3b sidecar slice: {wall:.3f} s wall (pack + dispatch + "
        f"fetch), lean={lean}, launches {counts}; the dispatch uploaded "
        f"{uploaded:.0f} bytes (pred edges + actor map {small}), host_args "
        f"ran {len(host_args_calls)} times, host planes still copying at "
        f"the dispatch: {copying}")
    for k in SLICE2:
        if counts[k] != 1:
            raise AssertionError(
                f"kernel {k} launched {counts[k]} times on the sidecar "
                f"slice, expected 1"
            )
    if counts["materialize"] or counts["summary_wire"]:
        raise AssertionError(f"the sidecar slab took more than one launch "
                             f"of kernels 1-2: {counts}")
    if host_args_calls or batch.lanes is None:
        raise AssertionError("the sidecar slab's dispatch did not take the "
                             "pack's device lanes")
    if uploaded != small:
        raise AssertionError(f"the dispatch uploaded {uploaded} bytes, "
                             f"expected the pred edges + actor map's {small}")
    return batch, out, arrays, lean, counts


def check_slice(ck, columnar, mat, hists, batch, out, arrays, lean):
    """The sidecar slice against the first slice's path over the same
    histories: live counts of every doc, decoded patches of 64 docs
    (the contract of pack_docs_columns: equal patches, not equal
    bytes — table ids differ between the two packs)."""
    import numpy as np

    ref = columnar.pack_docs(hists)
    ref_out, ref_wire = ck.run_batch_full(ref)
    ref_arrays = mat.fetch_summary(ref_wire, ref)
    n = SLAB["n_docs"]
    tmpl = np.arange(n) % TEMPLATES
    for key in ("n_live_elems", "n_map_entries"):
        if not np.array_equal(arrays[key][:n], ref_arrays[key][tmpl]):
            raise AssertionError(f"sidecar slice {key} != first slice")
    clocks = [{hists[t][0].actor: len(hists[t])} for t in tmpl]
    dec = mat.DecodedBatch(batch, out, host_clocks=clocks if lean else None)
    ref_dec = mat.DecodedBatch(ref, ref_out)
    # 64 docs spread over the slab, every template among them
    sample = [(i * (n // 64) + i % TEMPLATES) % n for i in range(64)]
    for d in sample:
        got = mat.decode_patch(dec, d).to_json()
        if got != mat.decode_patch(ref_dec, d % TEMPLATES).to_json():
            raise AssertionError(f"sidecar slice doc {d}: patch differs")
    log(f"phase 3b check: live counts of {n} docs and patches of "
        f"{len(sample)} docs == first slice's path")


def host_medians_ms(fns, runs=7, warmup=2):
    """{name: median host wall in ms} of each fn() ending in a
    synchronize; the fns take turns in every round, so that host noise
    falls on all of them alike."""
    import torch

    for _ in range(warmup):
        for fn in fns.values():
            fn()
            torch.cuda.synchronize()
    times = {name: [] for name in fns}
    for _ in range(runs):
        for name, fn in fns.items():
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t0) * 1e3)
    return {name: statistics.median(t) for name, t in times.items()}


def kernel_device_ms(fn, name: str, runs=20) -> float | None:
    """Mean device time of the kernel called `name` (the whole identifier,
    demangled or mangled) over `runs` calls of fn, from torch.profiler.
    A window in which the profiler delivered no record of it is tried
    again; after PROFILE_TRIES such windows the time is not measured
    (None). It is a reading beside the CUDA-event times, not a check."""
    return kernels_device_ms(fn, (name,), runs)[0]


def kernels_device_ms(fn, names, runs=20):
    """(mean device time per call of fn summed over every kernel whose
    identifier is one of `names`, the kernels of those names per call),
    from torch.profiler, as kernel_device_ms reads one; (None, None) when
    not measured."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    # demangled: the bare identifier; mangled: its length, then the name
    pat = re.compile("|".join(
        rf"(?<!\w){re.escape(n)}(?!\w)|{len(n)}{re.escape(n)}" for n in names))
    label = names[0] if len(names) == 1 else f"{len(names)} kernels"
    fn()
    torch.cuda.synchronize()
    for attempt in range(1, PROFILE_TRIES + 1):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(PROFILE_PAD_S)
            for _ in range(runs):
                fn()
            torch.cuda.synchronize()
            time.sleep(PROFILE_PAD_S)
        hits = [e for e in prof.key_averages() if pat.search(e.key)]
        total = sum(dev_us(e) for e in hits)
        if total > 0:
            return total / runs / 1e3, sum(e.count for e in hits) / runs
        log(f"profiler: no device record of {label} (window {attempt} of "
            f"{PROFILE_TRIES})")
    log(f"profiler: {label} alone not measured")
    return None, None


def dev_us(e):
    return getattr(e, "self_device_time_total", None) or getattr(
        e, "self_cuda_time_total", 0
    )


def pack_bound(k_slab, out):
    """(bytes, operations) the pack must move and do at this slab: the
    source planes, per-doc vectors and LUTs read once, the 11 wire
    planes, flags, slot and the ranges written once; per cell the row
    test, 4 compares / selects for obj and ref, 2 LUT index clamps, the
    flags and 4 folds: ~16 integer operations."""
    in_bytes = nbytes(*k_slab["planes"], k_slab["doc_start"], k_slab["ends"],
                      k_slab["writer"], k_slab["lut_off"], *k_slab["luts"])
    out_bytes = nbytes(*out.planes, out.flags, out.slot) + 4 * 5
    return in_bytes + out_bytes, 16 * k_slab["Dp"] * k_slab["N"]


def time_pack(pk, ck, columnar, mat, fcs, k_slab, lean):
    """pack_prefix numbers at the slab (the wrapper, its host work, the
    kernel alone warm and with the L2 flushed before each call, the plain
    version, the bound), the pack's host stages, and the sidecar slab's
    profile (pack + dispatch + fetch: device time by kernel, idle share,
    copies by direction)."""
    import numpy as np
    import torch

    specs = slab_specs(fcs, SLAB["n_docs"])
    kw = dict(n_docs=SLAB["n_docs"], n_rows=SLAB["n_ops"])
    _b, calls = capture(
        pk, "device_pack_prefix",
        lambda: columnar.pack_docs_columns(specs, device="cuda", **kw),
    )
    a = calls[0][0]  # fcs, fc_idx, fc_idx_a, ends, writer_g, flat_lut, ...
    N = k_slab["N"]
    dev = torch.device("cuda")
    inp = pk.marshal_pack_inputs(*a[:6], N, dev)

    def call():
        return pk.pack_prefix_cuda(**k_slab)

    flush = torch.empty(4 * L2_BYTES, dtype=torch.uint8, device=dev)

    def cold():
        flush.zero_()
        return call()

    nbytes_, ops = pack_bound(k_slab, call())
    r = dict(
        ms=median_ms(call),
        host_ms=host_call_ms(call),
        kernel_ms=kernel_device_ms(call, "pack_prefix_kernel"),
        cold_kernel_ms=kernel_device_ms(cold, "pack_prefix_kernel"),
        plain_ms=median_ms(lambda: pk.pack_prefix_plain(**k_slab)),
        library_ms=None,
        bytes=nbytes_,
        ops=ops,
    )
    # the pack's host stages: the marshal into the staging buffer (one
    # native call; its numpy twin beside it), its one copy up, the whole
    # emit (marshal, upload, kernel, the planes' copy down started) and
    # the whole pack; the host route beside them: the native emit alone
    # (hm_pack_value_minmax + hm_pack_prefix) and its whole pack
    fcs_, _fc_idx, fc_idx_a, ends, writer_g, flat_lut, Dp, _N, i16ok, \
        row_dt, kdt, _dev = a
    lib = columnar._native_pack_lib()

    def marshal_numpy():
        with env_vars(HM_NATIVE_PACK="0"):
            return pk.marshal_pack_inputs(*a[:6], N, dev)

    def host_pack():
        with env_vars(HM_DEVICE_PACK="0"):
            return columnar.pack_docs_columns(specs, device="cuda", **kw)

    r.update(host_medians_ms({
        "marshal_ms": lambda: pk.marshal_pack_inputs(*a[:6], N, dev),
        "marshal_numpy_ms": marshal_numpy,
        "upload_ms": lambda: pk.upload(inp, dev),
        "device_pack_prefix_ms": lambda: pk.device_pack_prefix(*a),
        "pack_docs_columns_ms": lambda: columnar.pack_docs_columns(
            specs, device="cuda", **kw
        ),
        "native_pack_ms": lambda: columnar._native_pack_prefix(
            lib, fcs_, fc_idx_a, ends, writer_g, flat_lut, len(ends), Dp, N,
            i16ok, row_dt, kdt),
        "host_pack_docs_columns_ms": host_pack,
    }))
    t_bytes = r["bytes"] / MEM_BYTES_PER_S * 1e3
    t_ops = r["ops"] / SCALAR_OPS_PER_S * 1e3
    r["bound_ms"] = max(t_bytes, t_ops)
    r["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    r["marshal_share"] = r["marshal_ms"] / r["pack_docs_columns_ms"]
    log(f"timing pack [{k_slab['Dp']}, {k_slab['N']}] "
        f"M={k_slab['planes'][0].shape[0]}: "
        + " ".join(f"{k}={v!r}" for k, v in r.items()))
    if not np.isfinite(r["ms"]):
        raise AssertionError("pack_prefix time is not finite")

    def sidecar_dispatch():
        b = columnar.pack_docs_columns(specs, device="cuda", **kw)
        _o, w = ck.run_batch_full(b, lean=lean)
        mat.fetch_summary(w, b, lean=lean)

    sidecar_dispatch()
    prof = profile_dispatch("sidecar slab (pack + dispatch + fetch)",
                            sidecar_dispatch)
    r["sidecar_copies"] = prof["copies"]
    r["sidecar_idle_share"] = prof["device_idle_share"]
    return r


def time_pack_shape(pk, label, k):
    """pack_prefix at another shape of phase 2 (the ragged slab, the
    65,536-row int32 doc): wrapper, kernel alone warm and cold, bound."""
    import torch

    def call():
        return pk.pack_prefix_cuda(**k)

    flush = torch.empty(4 * L2_BYTES, dtype=torch.uint8, device="cuda")

    def cold():
        flush.zero_()
        return call()

    nbytes_, ops = pack_bound(k, call())
    r = dict(ms=median_ms(call), kernel_ms=kernel_device_ms(
        call, "pack_prefix_kernel"), cold_kernel_ms=kernel_device_ms(
        cold, "pack_prefix_kernel"), plain_ms=median_ms(
        lambda: pk.pack_prefix_plain(**k)),
        bound_ms=max(nbytes_ / MEM_BYTES_PER_S, ops / SCALAR_OPS_PER_S) * 1e3)
    log(f"timing pack {label} [{k['Dp']}, {k['N']}] "
        f"M={k['planes'][0].shape[0]} row32={k['row32']}: "
        + " ".join(f"{key}={v!r}" for key, v in r.items()))
    return r


# -- the clock slice ----------------------------------------------------------


def clock_matrix(seed, D, A, hi=1000, inf_frac=0.02):
    """[D, A] int32 clocks on the card: uniform in [0, hi) with INT32_INF
    entries."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    m = rng.integers(0, hi, size=(D, A)).astype(np.int32)
    m[rng.random((D, A)) < inf_frac] = 2**31 - 1
    return torch.from_numpy(m).cuda()


def hold(label, got, want) -> int:
    """Raise unless got equals want exactly; returns the max abs err."""
    import torch

    pairs = list(zip(got, want)) if isinstance(got, tuple) else [(got, want)]
    torch.cuda.synchronize()
    err = 0
    for g, w in pairs:
        if g.dtype != w.dtype or g.shape != w.shape or not torch.equal(g, w):
            raise AssertionError(f"{label}: kernel != plain")
        err = max(err, max_abs_err(g, w))
    return err


def union_route_cases():
    """(label, [D, A] int32 on the card) of the column reduce's phase-2
    holds beyond the main shapes: the pmin's [2, 50000], a short matrix,
    both sides of the columns route's boundary (D = 64 and 65), an A that
    is not a multiple of 4, a base 4 bytes past an aligned address (a
    view of an offset flat buffer), negative values and the int32 ends."""
    import numpy as np
    import torch

    rng = np.random.default_rng(11)
    i32 = np.iinfo(np.int32)
    cases = []
    for D, A in ((2, CONFIG5["n_docs"] // 2), (4, 64), (64, 1000),
                 (65, 1000), (2, 4099), (3, 4096)):
        m = clock_matrix(D * A, D, A)
        ends = torch.from_numpy(rng.choice(
            [i32.min, i32.min + 1, -1, 0, 1, i32.max - 1, i32.max],
            (D, A)).astype(np.int32)).cuda()
        cases += [(f"[{D}, {A}]", m), (f"[{D}, {A}] negative", -1 - m.abs()),
                  (f"[{D}, {A}] int32 ends", ends)]
    flat = torch.empty(3 * 4096 + 1, dtype=torch.int32, device="cuda")
    flat[1:] = clock_matrix(7, 3, 4096).flatten()
    off = flat[1:].view(3, 4096)
    if off.data_ptr() % 16 != 4:
        raise AssertionError("the offset view is not 4 bytes off alignment")
    cases.append(("[3, 4096] base + 4 bytes", off))
    return cases


def hold_column_reduce(kernel, plain, mode):
    """Phase 2's route cases of one mode of clock_union.cu; returns the
    max abs err."""
    err = 0
    cases = union_route_cases()
    for label, x in cases:
        err = max(err, hold(f"clock_union {mode} {label}", kernel(x), plain(x)))
    log(f"phase 2 clock_union {mode} on both routes ({len(cases)} cases: "
        f"{', '.join(label for label, _ in cases)}): kernel == plain (exact)")
    return err


def pair_lanes(A: int) -> tuple:
    """(G, vector route) of clock_pair.cu at A actors on aligned operands:
    G the power of two at or above ceil(A / 4), at most 32."""
    g = 1
    while g < -(-A // 4) and g < 32:
        g *= 2
    return g, A % 4 == 0


def hold_pair_routes(ckk, m):
    """Phase 2's route cases of clock_pair.cu, every op on each: the
    device route (the row on either side, and two full matrices), the
    by-value query on either side with the result on the card and through
    the pinned buffer (pair_query_cuda), at G = 1 .. 32 on the int4 and
    the scalar route, A above 128 and 256, R = 1 and odd R, config 5's
    [131072, 64] (m), and a base one int off 16-byte alignment. Returns
    the max abs err."""
    import numpy as np
    import torch

    shapes = ((1, 64), (37, 1), (37, 3), (501, 4), (1000, 8), (1000, 16),
              (999, 32),
              (5000, 70), (777, 128), (300, 260), (64, 1024))
    cases = [(f"[{R}, {A}]", clock_matrix(R * 7 + A, R, A)) for R, A in shapes]
    cases.insert(0, (f"[{m.shape[0]}, 64]", m))
    flat = torch.empty(37 * 64 + 1, dtype=torch.int32, device="cuda")
    flat[1:] = clock_matrix(8, 37, 64).flatten()
    off = flat[1:].view(37, 64)
    if off.data_ptr() % 16 != 4:
        raise AssertionError("the offset view is not 4 bytes off alignment")
    cases.append(("[37, 64] base + 4 bytes", off))
    err, lanes, n = 0, set(), 0
    for label, x in cases:
        R, A = x.shape
        row = x[R // 2].clone()
        row[::3] = 990
        y = x.clone()
        y[1::3] = torch.clamp(x[1::3] - 1, min=0)
        y[2::3] += 1
        rowh = row.cpu().numpy()
        if label.endswith("bytes"):
            row = torch.empty(A + 1, dtype=torch.int32, device="cuda")[1:]
            row.copy_(torch.from_numpy(rowh))
        else:
            lanes.add(pair_lanes(A))
        for op, plain in ckk._PLAIN_PAIR.items():
            holds = [("full", ckk.pair_cuda(op, x, y), plain(x, y)),
                     ("row a", ckk.pair_cuda(op, row, x), plain(row, x)),
                     ("row b", ckk.pair_cuda(op, x, row), plain(x, row))]
            for side in (0, 1):
                want = plain(row, x) if side == 0 else plain(x, row)
                if label.endswith("bytes"):
                    continue  # the by-value route reads no device row
                holds.append((f"by value {side}",
                              ckk.pair_query_cuda(op, rowh, x, side), want))
                got = ckk.pair_query_cuda(op, rowh, x, side, to_host=True)
                holds.append((f"pinned {side}", torch.from_numpy(got), want.cpu()))
            for route, got, want in holds:
                err = max(err, hold(f"clock_pair op {op} {label} {route}",
                                    got, want))
                n += 1
    want_lanes = {(g, v) for g in (1, 2, 4, 8, 16, 32) for v in (True,)} | {
        (1, False), (32, False)}
    if not want_lanes <= lanes:
        raise AssertionError(f"clock_pair phase 2 ran lanes {sorted(lanes)}")
    log(f"phase 2 clock_pair routes ({n} holds: "
        f"{', '.join(label for label, _ in cases)}; every op on the device "
        f"route, the row on either side, by value and through the pinned "
        f"buffer; G and int4 route {sorted(lanes)}): kernel == plain (exact)")
    return err


def compare_clock_kernels(ckk):
    """Phase 2 for the clock kernels: each against its plain version on
    the same card tensors; returns the max abs err per kernel."""
    import numpy as np
    import torch

    from hypermerge_tpu_torch.ops.crdt_kernels import launch_cap as ck_launch_cap

    D = 131072  # the mirror's capacity at config 5
    errs = dict.fromkeys(CLOCKS, 0)
    m = clock_matrix(0, D, 64)
    for A, rows in ((64, D), (3, D), (1024, 16384)):
        a = m if A == 64 else clock_matrix(A, rows, A)
        b = clock_matrix(A + 1, rows, A)
        b[::3] = a[::3]  # EQ rows
        for op, plain in ckk._PLAIN_PAIR.items():
            for x, y in ((a, b), (b[9], a), (a, b[9])):
                e = hold(f"clock_pair op {op} A={A}", ckk.pair_cuda(op, x, y),
                         plain(x, y))
                errs["clock_pair"] = max(errs["clock_pair"], e)
    errs["clock_pair"] = max(errs["clock_pair"], hold_pair_routes(ckk, m))
    small = clock_matrix(5, 5, 3)
    for x in (m, small, -1 - m.abs(), -1 - small.abs()):
        e = hold(f"clock_union {tuple(x.shape)}", ckk.union_reduce_cuda(x),
                 ckk.union_reduce_plain(x))
        errs["clock_union"] = max(errs["clock_union"], e)
    errs["clock_union"] = max(errs["clock_union"], hold_column_reduce(
        ckk.union_reduce_cuda, ckk.union_reduce_plain, "max"))
    rng = np.random.default_rng(1)
    for n in (1000, 65536):
        trip = [torch.from_numpy(rng.integers(0, hi, n).astype(np.int32)).cuda()
                for hi in (D, 64, 3000)]
        trip[0][: n // 2], trip[1][: n // 2] = 17, 5  # one hot cell
        e = hold(f"clock_scatter n={n}", ckk.scatter_max_cuda_(m.clone(), *trip),
                 ckk.scatter_max_plain_(m.clone(), *trip))
        errs["clock_scatter"] = max(errs["clock_scatter"], e)
    # the parameter route (the mirror's flush): host triples, at the
    # flush's 1,024 and above one launch's cap, with duplicates and
    # triples outside the matrix
    cap = ck_launch_cap("clock_scatter")
    for n in (1024, 2 * cap + 1):
        host = [rng.integers(0, hi, n).astype(np.int32) for hi in (D, 64, 3000)]
        host[0][: n // 2], host[1][: n // 2] = 17, 5  # one hot cell
        host[0][-1], host[1][-2] = D, -1  # dropped
        trip = [torch.from_numpy(a).cuda() for a in host]
        e = hold(f"clock_scatter params n={n}",
                 ckk.scatter_max_params_cuda_(m.clone(), *host),
                 ckk.scatter_max_plain_(m.clone(), *trip))
        errs["clock_scatter"] = max(errs["clock_scatter"], e)
    ties = m % 4  # mass ties: row sums from a handful of values
    ties[::97] = 2**31 - 1  # INT32_INF rows: must rank first, not wrap
    q_all = torch.full((64,), 2**31 - 1, dtype=torch.int32, device="cuda")
    q = torch.full((64,), 990, dtype=torch.int32, device="cuda")
    T = ckk.TOPK_TILE
    straddle = m % 2  # equal rows on both sides of every tile boundary
    for b in range(T, D, T):
        straddle[b - 7 : b + 7] = 3
    ragged = ties[: D - 77]  # a row count that is not a multiple of the tile
    routes = set()
    for x, qq, ks in ((ties, q_all, (1, 64, D)), (ties, q, (1, 64, D)),
                      (m, q, (1, 64, D)), (straddle, q_all, (64, T + 1)),
                      (ragged, q_all, (1, 64, T + 1, D - 77))):
        for k in ks:
            route = ckk.topk_plan(x.shape[0], k)[0]
            routes.add(route)
            e = hold(f"clock_topk {route} [{x.shape[0]}, 64] k={k}",
                     ckk.top_k_dominated_cuda(x, qq, k),
                     ckk.top_k_dominated_plain(x, qq, k))
            errs["clock_topk"] = max(errs["clock_topk"], e)
    if routes != {"select", "sort"}:
        raise AssertionError(f"clock_topk phase 2 ran routes {routes}")
    log(f"phase 2 clock kernels at [{D}, 64] (pairwise also at A=3, 1024; "
        f"top-k on both routes, ties across tiles, k = {T + 1}, "
        f"{D - 77} rows; the scatter's parameter route at n = 1024 and "
        f"{2 * cap + 1}): kernels == plain (exact)")
    return errs


def config5_mirrors(PM):
    """(a mirror on the card, one on the CPU), both seeded as bench.py's
    _config5_union seeds its mirror."""
    import numpy as np

    n, A = CONFIG5["n_docs"], CONFIG5["n_actors"]
    clocks = np.random.default_rng(0).integers(1, 1000, size=(n, A),
                                                 dtype=np.int32)
    docs = [f"d{i}" for i in range(n)]
    actors = [f"a{j}" for j in range(A)]
    gpu = PM.DeviceClockMirror(capacity_docs=n, capacity_actors=A)
    cpu = PM.DeviceClockMirror(capacity_docs=n, capacity_actors=A,
                               device="cpu")
    for mirror in (gpu, cpu):
        mirror.seed_bulk(docs, actors, clocks)
    return gpu, cpu, actors


def clock_path(ck, PM):
    """The clock slice's main path, config 5 on the card: counts set to 0
    just before and read just after; every answer and the matrix held
    against the CPU mirror fed the same calls. Returns the counts."""
    import torch

    gpu, cpu, actors = config5_mirrors(PM)
    q = {a: 990 for a in actors}
    torch.cuda.synchronize()

    def drive(mirror):
        for i in range(CONFIG5["dirty"]):
            mirror.update(f"d{i}", {actors[i % len(actors)]: 2000 + i})
        return (mirror.union(), mirror.dominated(q),
                mirror.top_k_dominated(q, 64))

    for k in ck.launches:
        ck.launches[k] = 0
    t0 = time.perf_counter()
    got = drive(gpu)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(ck.launches)
    log(f"phase 3c clock slice (config 5, {CONFIG5['n_docs']} x "
        f"{CONFIG5['n_actors']}): {wall:.3f} s wall (1,000 updates, union, "
        f"dominated, top-k 64), launches {counts}")
    for k, v in counts.items():
        if v != (1 if k in CLOCKS else 0):
            raise AssertionError(f"clock slice: {k} launched {v} times")
    want = drive(cpu)
    for name, g, w in zip(("union", "dominated", "top_k_dominated"), got, want):
        if g != w:
            raise AssertionError(f"config 5 {name}: card != CPU")
    union, dominated, top = got
    if len(union) != CONFIG5["n_actors"] or union[actors[-1]] < 2000:
        raise AssertionError(f"config 5 union is wrong: {union}")
    if not dominated or len(top) != 64:
        raise AssertionError("config 5: no dominated docs")
    if not torch.equal(gpu._mat().cpu(), cpu._mat()):
        raise AssertionError("config 5: the card's matrix != the CPU's")
    if gpu._docs != cpu._docs or gpu.actor_index != cpu.actor_index:
        raise AssertionError("config 5: mirror indexes differ")
    log(f"phase 3c check: union of {len(union)} actors, {len(dominated)} "
        f"dominated docs, top-64 and the {tuple(gpu._mat().shape)} matrix == "
        f"the CPU mirror")
    return counts, gpu, actors


def store_path(ck, PM, sql, stores):
    """A sqlite ClockStore with a mirror attached, on the card and on the
    CPU, through one seeded mix of writes; both query routes held
    against the CPU. Returns the counts of the card's run."""
    import random

    import torch

    n, A = STORE["n_docs"], STORE["n_actors"]
    docs = [f"doc{i}" for i in range(n)]
    actors = [f"actor{j}" for j in range(A)]
    rnd = random.Random(STORE["seed"])
    seed_rows = {d: {a: rnd.randrange(1, 500) for a in actors} for d in docs}
    ops = []
    for _ in range(STORE["steps"]):
        doc = rnd.choice(docs)
        clock = {rnd.choice(actors): rnd.randrange(1, 1000)
                 for _ in range(rnd.randrange(1, 5))}
        r = rnd.random()
        if r < 0.6:
            ops.append(("update", ("r", doc, clock)))
        elif r < 0.8:
            ops.append(("update_many",
                        ("r", {rnd.choice(docs): clock for _ in range(4)})))
        elif r < 0.95:
            ops.append(("set", ("r", doc, clock)))
        else:
            ops.append(("delete_doc", (doc,)))
    subset = docs[::4]
    queries = [{a: 700 for a in actors}, {a: 999 for a in actors[:8]}]

    def run(device):
        store = stores.ClockStore(sql.SqlDatabase(":memory:"), device=device)
        store.update_many("r", seed_rows)
        store.attach_mirror("r", PM.DeviceClockMirror(device=device))
        out = [store.union_query("r")]
        for name, args in ops:
            getattr(store, name)(*args)
        out.append(store.union_query("r"))
        out.append(store.union_query("r", subset))
        for q in queries:
            out.append(store.dominated_query("r", q))
            out.append(store.dominated_query("r", q, subset))
        out.append(store.mirror.rows())
        return out

    for k in ck.launches:
        ck.launches[k] = 0
    t0 = time.perf_counter()
    got = run(None)  # the default device: the card
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(ck.launches)
    if got != run("cpu"):
        raise AssertionError("ClockStore on the card != on the CPU")
    for k in ("clock_scatter", "clock_union", "clock_pair"):
        if counts[k] < 1:
            raise AssertionError(f"ClockStore: {k} never launched")
    log(f"phase 3c ClockStore ({n} docs x {A} actors, {len(ops)} writes, "
        f"both query routes): {wall:.3f} s wall, launches {counts}; "
        f"answers == the CPU store")
    return counts


def time_clock_kernels(ckk, PM, mirror, actors):
    """Phase 4 for the clock kernels at the config-5 mirror's matrix, and
    config 5's hot query wall; {kernel: numbers}."""
    import numpy as np
    import torch

    m = mirror._mat()
    D, A = m.shape
    q = torch.full((A,), 990, dtype=torch.int32, device="cuda")
    res = {}
    res["clock_pair"] = time_pair(ckk, m, q, mirror, actors)
    u = ckk.union_reduce_cuda(m)
    res["clock_union"] = dict(
        ms=median_ms(lambda: ckk.union_reduce_cuda(m)),
        plain_ms=median_ms(lambda: ckk.union_reduce_plain(m)),
        library_ms=median_ms(lambda: torch.amax(m, dim=0)),
        bytes=nbytes(m, u), ops=D * A,
    )
    # the pending flush of config 5: 1,000 writes, padded to 1,024, as the
    # mirror hands them over (host arrays: the parameter route, timed as
    # `ms`) and the same triples on the card (the device-triple route)
    n = CONFIG5["dirty"]
    rng = np.random.default_rng(2)
    trip = np.zeros((3, 1024), np.int32)
    trip[0, :n] = rng.integers(0, D, n)
    trip[1, :n] = rng.integers(0, A, n)
    trip[2, :n] = 2000 + np.arange(n)
    host = [np.ascontiguousarray(x) for x in trip]
    t = torch.from_numpy(trip).cuda()
    target = m.clone()
    idx = t[0].long() * A + t[1].long()
    cells = int(torch.unique(idx).numel())
    res["clock_scatter"] = dict(
        n=1024,
        ms=median_ms(lambda: ckk.scatter_max_params_cuda_(target, *host)),
        host_ms=host_call_ms(lambda: ckk.scatter_max_params_cuda_(target, *host)),
        device_route_ms=median_ms(
            lambda: ckk.scatter_max_cuda_(target, t[0], t[1], t[2])),
        device_route_host_ms=host_call_ms(
            lambda: ckk.scatter_max_cuda_(target, t[0], t[1], t[2])),
        plain_ms=median_ms(lambda: ckk.scatter_max_plain_(target, t[0], t[1],
                                                          t[2])),
        library_ms=median_ms(lambda: target.view(-1).scatter_reduce_(
            0, idx, t[2], "amax")),
        # the triples read once, each touched cell read and written once
        bytes=nbytes(t) + 8 * cells, ops=t.shape[1],
    )
    # the parameter route alone, cold: each call's 1,024 fresh triples
    # over a matrix of 4 x the L2, so that its cells come from HBM
    big = torch.zeros(4 * L2_BYTES // (4 * A), A, dtype=torch.int32,
                      device="cuda")

    def cold_scatter(i):
        r = np.random.default_rng(100 + i)
        tr = [r.integers(0, hi, 1024).astype(np.int32)
              for hi in (big.shape[0], A, 5000)]
        return lambda: ckk.scatter_max_params_cuda_(big, *tr)

    res["clock_scatter"]["cold_kernel_ms"] = cold_calls_ms(cold_scatter)
    del big
    res["clock_scatter"]["structs"] = time_param_structs(ckk, target)
    res["clock_scatter"]["device_route_kernel_ms"] = kernel_device_ms(
        lambda: ckk.scatter_max_cuda_(target, t[0], t[1], t[2]),
        "scatter_max_kernel")
    res["clock_scatter"].update(time_mirror_flush(PM, mirror, actors))
    k = 64
    s, i = ckk.top_k_dominated_cuda(m, q, k)
    score = ckk.top_k_scores_plain(m, q)
    res["clock_topk"] = dict(
        route=ckk.topk_plan(D, k)[0],
        ms=median_ms(lambda: ckk.top_k_dominated_cuda(m, q, k), HOST_BOUND_RUNS),
        host_ms=host_call_ms(lambda: ckk.top_k_dominated_cuda(m, q, k)),
        plain_ms=median_ms(lambda: ckk.top_k_dominated_plain(m, q, k),
                           HOST_BOUND_RUNS),
        library_ms=median_ms(lambda: torch.topk(score, k), HOST_BOUND_RUNS),
        # the matrix and query read once, k pairs written; per element a
        # compare, a min and an add, then the selection over D scores
        bytes=nbytes(m, q, s, i), ops=3 * D * A + D * int(math.log2(D)),
    )
    # device time of the kernels alone, without the wrapper's host work
    qh = q.cpu().numpy()
    alone = {
        "clock_pair": (lambda: ckk.gte_host(qh, m), ("clock_pair_kernel",)),
        "clock_union": (lambda: ckk.union_reduce_cuda(m),
                        ("fill_kernel", "column_reduce_kernel")),
        "clock_scatter": (lambda: ckk.scatter_max_params_cuda_(target, *host),
                          ("scatter_params_kernel",)),
        "clock_topk": (lambda: ckk.top_k_dominated_cuda(m, q, k),
                       ("tile_kernel", "merge_kernel")),
    }
    for name, (fn, names) in alone.items():
        parts = [kernel_device_ms(fn, kn) for kn in names]
        res[name]["kernel_ms"] = None if None in parts else sum(parts)
        if name == "clock_topk":
            res[name]["tile_ms"], res[name]["merge_ms"] = parts
    for r in res.values():
        t_bytes = r["bytes"] / MEM_BYTES_PER_S * 1e3
        t_ops = r["ops"] / SCALAR_OPS_PER_S * 1e3
        r["bound_ms"] = max(t_bytes, t_ops)
        r["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    for name, r in res.items():
        log(f"timing {name} [{D}, {A}]: " + " ".join(
            f"{key}={v!r}" for key, v in r.items()))

    # config 5's hot query, as bench.py times it: 1,000 fresh writes land
    # and the union runs, host buffering included (fresh values each run)
    rounds = iter(range(1, 100))

    def hot_query():
        base = 3000 * next(rounds)
        for j in range(n):
            mirror.update(f"d{j}", {actors[j % A]: base + j})
        return mirror.union()

    walls = host_medians_ms({"hot_query_ms": hot_query,
                             "union_alone_ms": mirror.union})
    log(f"timing config 5 hot query (1,000 writes + union): "
        f"wall_ms={walls['hot_query_ms']!r}; union() with nothing pending "
        f"{walls['union_alone_ms']!r} ms")
    return res, walls["hot_query_ms"]


def time_pair(ckk, m, q, mirror, actors):
    """clock_pair.cu's phase-4 numbers at the config-5 matrix m: `ms` and
    `host_ms` of the main path's entry, gte_host (the query by value, the
    verdicts through the pinned buffer, ending in the stream's sync);
    the device route (pair_cuda, the row read from the card, the result
    left there); the kernel alone cold (cold_kernel_ms over copies of m);
    the plain version, the two-call PyTorch form torch.all(m <= q) and
    mirror.dominated's wall, with its parts taken in turn with it: the
    query row built from the dict, gte_host, and the doc ids listed on
    the host (the mirror's own expressions)."""
    import torch

    D, A = m.shape
    qh = q.cpu().numpy()
    out = ckk.pair_cuda(ckk._GTE, q, m)
    mats = [m.clone() for _ in range(max(2, math.ceil(4 * L2_BYTES / nbytes(m))))]
    query = {a: 990 for a in actors}
    ok = ckk.gte_host(qh, m)
    walls = host_medians_ms({
        "dominated_wall_ms": lambda: mirror.dominated(query),
        "dominated_query_row_ms": lambda: mirror._query_row(query),
        "dominated_scan_ms": lambda: ckk.gte_host(qh, m),
        "dominated_listing_ms": lambda: [
            d for d, r in mirror.doc_index.items() if ok[r]],
    })
    r = dict(
        ms=median_ms(lambda: ckk.gte_host(qh, m)),
        host_ms=host_call_ms(lambda: ckk.gte_host(qh, m)),
        device_route_ms=median_ms(lambda: ckk.pair_cuda(ckk._GTE, q, m)),
        device_route_host_ms=host_call_ms(lambda: ckk.pair_cuda(ckk._GTE, q, m)),
        cold_kernel_ms=cold_kernel_ms(
            lambda i: (lambda: ckk.gte_row(qh, mats[i % len(mats)])),
            nbytes(m, q, out)),
        plain_ms=median_ms(lambda: ckk.gte_plain(q, m)),
        library_ms=None,
        library_dispatch_ms=median_ms(lambda: torch.all(m <= q, dim=-1)),
        **walls, bytes=nbytes(m, q, out), ops=2 * D * A,
    )
    del mats
    return r


def time_param_structs(ckk, target):
    """clock_scatter's parameter route by struct: at 1,024 host triples in
    the 12 KB struct (the entry's choice) and in the 24 KB one, at 2,048
    in one launch of 24 KB (the entry's choice) and in two of 12 KB, each
    beside the device-triple route on the same triples: device time per
    call in a back-to-back stream (`cold_calls_ms` of one call repeated)
    and the host wall of one call ending in a synchronize (all in turns).
    params.cuh sizes the structs by this reading."""
    import numpy as np
    import torch

    from hypermerge_tpu_torch.ops import crdt_kernels as ck

    D, A = target.shape
    rng = np.random.default_rng(3)
    host = [rng.integers(0, hi, 2048).astype(np.int32) for hi in (D, A, 5000)]
    dev = [torch.from_numpy(a).cuda() for a in host]
    fn = ck.kernel_fn("clock_scatter_params")
    stream = ck.launch_stream(target.device)

    def params(n, per_launch):
        def call():
            if fn(target.data_ptr(), D, A, *(a.ctypes.data for a in host),
                  n, per_launch, stream):
                raise AssertionError("clock_scatter params failed to launch")
        return call

    calls = {"n1024_struct_12k": params(1024, 0),
             "n1024_struct_24k": params(1024, 2048),
             "n1024_device_route": lambda: ckk.scatter_max_cuda_(
                 target, *(d[:1024] for d in dev)),
             "n2048_struct_24k": params(2048, 0),
             "n2048_two_12k": params(2048, 1024),
             "n2048_device_route": lambda: ckk.scatter_max_cuda_(target, *dev)}
    walls = host_medians_ms(calls, runs=25, warmup=5)
    return {name: dict(stream_ms=cold_calls_ms(lambda _i, c=call: c),
                       wall_ms=walls[name])
            for name, call in calls.items()}


def time_mirror_flush(PM, mirror, actors, rounds=9, warmup=2):
    """The mirror's flush as the mirror runs it: 1,000 pending writes
    (`update`s made before the clock starts) scatter-maxed by
    `_scatter_pending` (host triples in the launch parameters), beside
    the library route on the same pending arrays (a pageable
    torch.from_numpy(...).to(dev) upload, then scatter_reduce_); host
    clock around each, ending in a synchronize, the two in turns.
    Returns {flush_ms, flush_library_ms} (medians)."""
    import numpy as np
    import torch

    n, A = CONFIG5["dirty"], len(actors)

    def library_flush():
        trip = torch.from_numpy(np.stack(mirror._pending_arrays())).to(
            mirror.device)
        mat = mirror._mat()
        mat.view(-1).scatter_reduce_(
            0, trip[0].long() * mat.shape[1] + trip[1].long(), trip[2], "amax")

    routes = {"flush_ms": mirror._scatter_pending,
              "flush_library_ms": library_flush}
    times = {name: [] for name in routes}
    base = 10**6
    for r in range(warmup + rounds):
        for name, flush in routes.items():
            base += 10**4
            for j in range(n):
                mirror.update(f"d{j}", {actors[j % A]: base + j})
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            flush()
            torch.cuda.synchronize()
            if r >= warmup:
                times[name].append((time.perf_counter() - t0) * 1e3)
    if mirror._pending:
        raise AssertionError("the flush left writes pending")
    return {name: statistics.median(v) for name, v in times.items()}


# -- the read slice -----------------------------------------------------------


class _Entry:
    """A resident entry as the serve kernels read it: its lanes."""

    def __init__(self, dev):
        self.dev = dev


def serve_inputs(synth, sk, B, N, scenario, seed):
    """(lane tensors on the card, qobj, qkey) of B batch slots: B - 1
    synthetic entries and, for B > 1, a pad slot repeating entry 0 with
    the NO_OBJ query, as stack_entries pads a batch."""
    import numpy as np
    import torch

    lanes, qobj, qkey = synth.synth_serve_lanes(B, N, scenario, seed=seed)
    t = torch.from_numpy(lanes).cuda()
    devs = list(t.unbind(0))
    if B > 1:
        devs[-1] = devs[0]
        qobj[-1], qkey[-1] = sk.NO_OBJ, -1
    return devs, qobj.astype(np.int32), qkey.astype(np.int32)


def serve_plain(sk, name, devs, qobj, qkey):
    """The plain version of one serve kernel on the card, as numpy."""
    import torch

    st = torch.stack(devs)
    qo = torch.from_numpy(qobj).cuda()
    qk = torch.from_numpy(qkey).cuda()
    out = {
        "serve_lookup": lambda: sk.map_lookup_plain(st, qo, qk),
        "serve_order": lambda: sk.seq_order_plain(st, qo),
        "serve_counts": lambda: sk.counts_plain(st, qo),
    }[name]()
    return tuple(x.cpu().numpy() for x in out)


def serve_cuda(sk, name, devs, qobj, qkey):
    return {
        "serve_lookup": lambda: sk.map_lookup_cuda(devs, qobj, qkey),
        "serve_order": lambda: sk.seq_order_cuda(devs, qobj),
        "serve_counts": lambda: sk.counts_cuda(devs, qobj),
    }[name]()


def compare_serve_kernels(synth, sk):
    """Phase 2 for the read-serving kernels; returns the max abs err per
    kernel and raises on any difference."""
    import numpy as np

    from hypermerge_tpu_torch.ops.crdt_kernels import launch_cap as sk_launch_cap

    errs = dict.fromkeys(SERVE, 0)
    for B in (1, 8, 64):
        for N in (64, 1024, 65536):
            for i, scenario in enumerate(synth.SERVE_SCENARIOS):
                devs, qobj, qkey = serve_inputs(synth, sk, B, N, scenario,
                                                seed=B * N + i)
                for name in SERVE:
                    got = serve_cuda(sk, name, devs, qobj, qkey)
                    want = serve_plain(sk, name, devs, qobj, qkey)
                    for g, w in zip(got, want):
                        g = np.asarray(g).astype(np.int64)
                        w = np.asarray(w).astype(np.int64)
                        if g.shape != w.shape:
                            raise AssertionError(f"{name} B={B} N={N}: shape")
                        errs[name] = max(errs[name], int(np.abs(g - w).max()))
                        if not np.array_equal(g, w):
                            raise AssertionError(
                                f"{name} B={B} N={N} {scenario}: kernel != "
                                "plain")
    log("phase 2 serve kernels at B in {1, 8, 64} x N in {64, 1024, 65536}, "
        f"scenarios {list(synth.SERVE_SCENARIOS)}: kernels == plain (exact)")
    # serve_order's split into a sorted head and a tail in row order: the
    # read mix's shapes, a batch above one launch's entries, and a
    # 65,536-row bucket (keys in global scratch; "all_live" takes the
    # global route), live rows of rank -2^31 + 1 and INT32_MIN included
    import torch

    cap = sk_launch_cap("serve_order", 0)
    shapes = ((1, 1024), (8, 1024), (cap + 2, 64), (3, 65536))
    for B, N in shapes:
        for case in synth.ORDER_CASES:
            lanes, qobj = synth.synth_order_lanes(case, B, N, seed=B + N)
            devs = list(torch.from_numpy(lanes).cuda().unbind(0))
            if B > 1:
                devs[-1], qobj[-1] = devs[0], sk.NO_OBJ
            got = sk.seq_order_cuda(devs, qobj)
            want = serve_plain(sk, "serve_order", devs, qobj,
                               np.full(B, -1, np.int32))
            for g, w in zip(got, want):
                if g.dtype != w.dtype or not np.array_equal(g, w):
                    raise AssertionError(
                        f"serve_order B={B} N={N} {case}: kernel != plain")
                errs["serve_order"] = max(
                    errs["serve_order"],
                    int(np.abs(g.astype(np.int64) - w.astype(np.int64)).max()))
    log(f"phase 2 serve_order at (B, N) in {list(shapes)}, cases "
        f"{list(synth.ORDER_CASES)}: kernel == plain (exact)")
    errs["serve_counts"] = max(errs["serve_counts"],
                               compare_counts_kernel(synth, sk))
    errs["serve_lookup"] = max(errs["serve_lookup"],
                               compare_lookup_kernel(synth, sk))
    return errs


def compare_lookup_kernel(synth, sk):
    """serve_lookup's phase-2 holds beyond the shared serve shapes: B in
    {1, 8, 64, 512} x N in {64, 1024, 65536} and a batch above one
    launch's entries (the launch splits), every scenario (misses and
    all-matching rows among them), two threads dispatching at once, and
    one thread alternating lookup, seq_order and counts dispatches of
    different sizes through its one pinned buffer. Returns the max abs
    err."""
    import threading

    import numpy as np

    from hypermerge_tpu_torch.ops.crdt_kernels import launch_cap

    def inputs(B, N, scenario, seed):
        devs, qobj, qkey = serve_inputs(synth, sk, B, N, scenario, seed)
        return devs, qobj, qkey, serve_plain(sk, "serve_lookup", devs, qobj,
                                             qkey)

    err = 0

    def check(label, got, want):
        nonlocal err
        for g, w in zip(got, want):
            if g.dtype != w.dtype or not np.array_equal(g, w):
                raise AssertionError(f"serve_lookup {label}: kernel != plain")
            err = max(err, int(np.abs(g.astype(np.int64)
                                      - w.astype(np.int64)).max()))

    cap = launch_cap("serve_lookup", 0)
    shapes = [(B, N) for B in (1, 8, 64, 512) for N in (64, 1024, 65536)
              if B * N <= 2**24] + [(cap + 2, 64)]
    for B, N in shapes:
        for i, scenario in enumerate(synth.SERVE_SCENARIOS):
            devs, qobj, qkey, want = inputs(B, N, scenario, seed=3 * B + N + i)
            check(f"B={B} N={N} {scenario}",
                  sk.map_lookup_cuda(devs, qobj, qkey), want)
    # two threads at once, each through its own pinned buffer
    work = [inputs(8 << (3 * i), 1024, "random", seed=70 + i) for i in range(2)]
    bad = []

    def run(i):
        devs, qobj, qkey, want = work[i]
        for _ in range(50):
            got = sk.map_lookup_cuda(devs, qobj, qkey)
            if not all(np.array_equal(g, w) for g, w in zip(got, want)):
                bad.append(i)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    if bad:
        raise AssertionError(f"serve_lookup from two threads: threads {bad} "
                             "read another dispatch's answer")
    # one thread: lookup, seq_order and counts in turn, sizes that grow
    # and shrink; every answer kept and checked after the last dispatch
    kept = []
    for B, N in ((1, 1024), (64, 4096), (2, 64), (512, 1024), (1, 2)):
        devs, qobj, qkey, want = inputs(B, N, "random", seed=B * N + 1)
        kept.append(("serve_lookup", sk.map_lookup_cuda(devs, qobj, qkey),
                     want))
        none = np.full(B, -1, np.int32)
        kept.append(("serve_order", sk.seq_order_cuda(devs, qobj),
                     serve_plain(sk, "serve_order", devs, qobj, none)))
        kept.append(("serve_counts", sk.counts_cuda(devs, qobj),
                     serve_plain(sk, "serve_counts", devs, qobj, none)))
    for name, got, want in kept:
        if name == "serve_lookup":
            check("alternating", got, want)
        elif not all(g.dtype == w.dtype and np.array_equal(g, w)
                     for g, w in zip(got, want)):
            raise AssertionError(f"{name} alternating with serve_lookup: "
                                 "kernel != plain")
    log(f"phase 2 serve_lookup at (B, N) in {shapes} (above {cap} entries "
        "the launch splits), scenarios "
        f"{list(synth.SERVE_SCENARIOS)}, from two threads at once, and in "
        "turn with serve_order and serve_counts on one thread: kernel == "
        "plain (exact)")
    return err


def compare_counts_kernel(synth, sk):
    """serve_counts' phase-2 holds beyond the shared serve shapes: B in
    {1, 8, 512} x N in {2, 1024, 65536}, a batch above one launch's
    entries (the launch splits), two threads dispatching at once, and one
    thread alternating seq_order and counts dispatches of different sizes
    through its one pinned buffer. Returns the max abs err."""
    import threading

    import numpy as np

    from hypermerge_tpu_torch.ops.crdt_kernels import launch_cap

    def inputs(B, N, scenario, seed):
        devs, qobj, _qkey = serve_inputs(synth, sk, B, N, scenario, seed)
        none = np.full(B, -1, np.int32)
        return devs, qobj, serve_plain(sk, "serve_counts", devs, qobj, none)

    err = 0

    def check(label, got, want):
        nonlocal err
        for g, w in zip(got, want):
            if g.dtype != w.dtype or not np.array_equal(g, w):
                raise AssertionError(f"serve_counts {label}: kernel != plain")
            err = max(err, int(np.abs(g.astype(np.int64)
                                      - w.astype(np.int64)).max()))

    cap = launch_cap("serve_counts", 0)
    shapes = [(B, N) for B in (1, 8, 512) for N in (2, 1024, 65536)
              if B * N <= 2**24] + [(cap + 2, 64)]
    for B, N in shapes:
        for i, scenario in enumerate(synth.SERVE_SCENARIOS):
            devs, qobj, want = inputs(B, N, scenario, seed=B + N + i)
            check(f"B={B} N={N} {scenario}", sk.counts_cuda(devs, qobj), want)
    # two threads at once, each through its own pinned buffer
    work = [inputs(8 << (3 * i), 1024, "random", seed=40 + i) for i in range(2)]
    bad = []

    def run(i):
        devs, qobj, want = work[i]
        for _ in range(50):
            got = sk.counts_cuda(devs, qobj)
            if not all(np.array_equal(g, w) for g, w in zip(got, want)):
                bad.append(i)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    if bad:
        raise AssertionError(f"serve_counts from two threads: threads {bad} "
                             "read another dispatch's answer")
    # one thread, seq_order and counts in turn, sizes that grow and shrink
    kept = []
    for B, N in ((1, 1024), (64, 4096), (2, 64), (512, 1024), (1, 2)):
        devs, qobj, want = inputs(B, N, "random", seed=B * N)
        kept.append((f"alternating B={B} N={N}", sk.counts_cuda(devs, qobj),
                     want))
        order_want = serve_plain(sk, "serve_order", devs, qobj,
                                 np.full(B, -1, np.int32))
        got = sk.seq_order_cuda(devs, qobj)
        for g, w in zip(got, order_want):
            if g.dtype != w.dtype or not np.array_equal(g, w):
                raise AssertionError(
                    f"serve_order alternating B={B} N={N}: kernel != plain")
    for label, got, want in kept:
        check(label, got, want)
    log(f"phase 2 serve_counts at (B, N) in {shapes} (above {cap} entries "
        "the launch splits), scenarios "
        f"{list(synth.SERVE_SCENARIOS)}, from two threads at once, and in "
        "turn with serve_order on one thread: kernel == plain (exact)")
    return err


def hist_quantile_ms(bounds, before, after, q):
    """Quantile (ms) from the delta of two Histogram.value() snapshots:
    the upper bound of the bucket where the cumulative count crosses q
    (the +Inf tail reports the largest finite bound), as bench.py
    reads the serve.read_s histogram."""
    counts = [b - a for a, b in zip(before["buckets"], after["buckets"])]
    n = sum(counts)
    if n <= 0:
        raise AssertionError("the read histogram recorded no reads")
    seen = 0
    for i, c in enumerate(counts):
        seen += c
        if seen >= q * n:
            return bounds[min(i, len(bounds) - 1)] * 1e3
    return bounds[-1] * 1e3


def quantile_ms(samples, q):
    """Nearest-rank quantile (ms) of raw per-read latencies (s)."""
    ordered = sorted(samples)
    return ordered[max(0, math.ceil(q * len(ordered)) - 1)] * 1e3


def run_threads(readers, fn):
    import threading

    errs = []

    def body(n):
        try:
            fn(n)
        except Exception as e:  # surfaced below
            errs.append(e)

    threads = [threading.Thread(target=body, args=(n,))
               for n in range(readers)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    dt = time.perf_counter() - t0
    if errs:
        raise errs[0]
    return dt


def read_path(ck, sk, root):
    """The read slice (bench.py _config_read) on the card. The corpus is
    written first (set-up); the launch counts are set to 0 just before
    the Repo opens and read just after the mixed pass. Returns (counts,
    the read mix's numbers, the dispatches captured for phase 4)."""
    import random
    from collections import Counter

    import numpy as np
    import torch

    from hypermerge_tpu_torch import native, telemetry
    from hypermerge_tpu_torch.ops.corpus import make_corpus
    from hypermerge_tpu_torch.repo import Repo
    from hypermerge_tpu_torch.serve.tier import host_read, host_value
    from hypermerge_tpu_torch.utils.ids import validate_doc_url

    # the .sig sidecars only where libsodium signs them: in pure Python
    # the signatures alone take minutes at this size, and the read path
    # never reads them (only replication verifies them)
    sign = bool(native.caps() & native.CAP_SODIUM)
    t0 = time.perf_counter()
    urls = make_corpus(root, READ["n_docs"], READ["n_ops"], sign=sign)
    log(f"phase 3d corpus: {READ['n_docs']} docs x {READ['n_ops']} ops "
        f"(signed={sign}) written in {time.perf_counter() - t0:.1f} s")

    # every serve dispatch's shape and inputs, for phase 4
    seen = {name: Counter() for name in SERVE}
    last = {}
    wrappers = {"serve_lookup": "map_lookup_cuda",
                "serve_order": "seq_order_cuda",
                "serve_counts": "counts_cuda"}
    origs = {name: getattr(sk, fn) for name, fn in wrappers.items()}

    def spy(name):
        def call(devs, *qs):
            key = (len(devs), devs[0].shape[1])
            seen[name][key] += 1
            last[(name, key)] = (list(devs), [np.array(q) for q in qs])
            return origs[name](devs, *qs)
        return call

    for name, fn in wrappers.items():
        setattr(sk, fn, spy(name))
    for k in ck.launches:
        ck.launches[k] = 0
    snap0 = telemetry.snapshot()
    repo = Repo(path=root)
    try:
        back = repo.back
        if back.serve is None:
            raise AssertionError("the repo has no serving tier")
        t0 = time.perf_counter()
        repo.open_many(urls)
        summ = back.fetch_bulk_summaries()
        t_open = time.perf_counter() - t0
        stats = dict(back.last_bulk_stats)
        if stats["fast"] != READ["n_docs"] or len(summ.doc_ids) != READ["n_docs"]:
            raise AssertionError(f"bulk open: {stats}")
        bulk = {k: ck.launches[k] for k in BULK}
        slabs = math.ceil(READ["n_docs"] / 4096)
        if any(v != slabs for v in bulk.values()):
            raise AssertionError(f"bulk kernels {bulk}, expected {slabs} each")
        log(f"phase 3d open_many + fetch_bulk_summaries: {t_open:.3f} s, "
            f"stats {stats}, launches {bulk}")

        sub, hot = urls, urls[: READ["hot"]]
        rng = random.Random(READ["seed"])
        mix = [
            hot[rng.randrange(len(hot))] if rng.random() < 0.9
            else sub[rng.randrange(len(sub))]
            for _ in range(READ["reads"])
        ]
        query = {"kind": "len", "path": []}

        def warm_hot():  # steady state: the hot set resident before timing
            for u in hot:
                repo.read(u, query)

        def read_mix(answers, lat):
            def reader(n):
                for i in range(n, len(mix), READ["readers"]):
                    t = time.perf_counter()
                    answers[i] = repo.read(mix[i], query)
                    lat[i] = time.perf_counter() - t
            return run_threads(READ["readers"], reader)

        warm_hot()
        hist = back.serve._hist
        h0 = hist.value()
        answers, lat = [None] * len(mix), [0.0] * len(mix)
        dt = read_mix(answers, lat)
        h1 = hist.value()
        docs = {u: back.docs[validate_doc_url(u)] for u in set(mix)}
        want = {u: host_read(d, query)["value"] for u, d in docs.items()}

        def check(answers):
            bad = [i for i, u in enumerate(mix) if answers[i] != want[u]]
            if bad or any(a is None for a in answers):
                raise AssertionError(
                    f"{len(bad)} len reads differ from host_read")

        check(answers)
        # the host twin on the whole mix, same threads (bench.py's baseline)
        host_lat = [0.0] * len(mix)

        def host_reader(n):
            for i in range(n, len(mix), READ["readers"]):
                t = time.perf_counter()
                if host_value(docs[mix[i]], query) != want[mix[i]]:
                    raise AssertionError("host twin read differs")
                host_lat[i] = time.perf_counter() - t

        host_dt = run_threads(READ["readers"], host_reader)
        # the same window again under torch.profiler for the device's
        # busy and idle share: residency dropped first, so it pays the
        # same installs (uploads) as the timed window
        back.serve._cache.clear()
        warm_hot()
        answers2, lat2 = [None] * len(mix), [0.0] * len(mix)
        prof = profile_dispatch(
            "read window (4,000 len reads, 8 threads)",
            lambda: read_mix(answers2, lat2))
        check(answers2)

        # the mixed pass: every read kind the kernels serve
        mixed = [{"kind": "lookup", "path": [f"k{i}"]} for i in range(10)]
        mixed += [{"kind": "text", "path": ["t"]},
                  {"kind": "len", "path": []}, {"kind": "len", "path": ["t"]}]
        n_mixed = 0
        for j, u in enumerate(hot):
            doc = docs.get(u) or back.docs[validate_doc_url(u)]
            qs = mixed + [{"kind": "index", "path": ["t"], "index": i}
                          for i in (0, j, 7 * j + 3, 10**6)]
            for q in qs:
                got = repo.read(u, q)
                if got != host_read(doc, q)["value"]:
                    raise AssertionError(f"read {q} of {u}: served != host")
                n_mixed += 1
        torch.cuda.synchronize()
        counts = dict(ck.launches)
        snap1 = telemetry.snapshot()
        # the single-device summaries, for phase 3e's product route
        rows = summary_rows(summ, [validate_doc_url(u) for u in urls])
    finally:
        repo.close()
        for name, fn in wrappers.items():
            setattr(sk, fn, origs[name])

    def delta(key):
        return int(snap1.get(key, 0) - snap0.get(key, 0))

    # a serve_order dispatch above one launch's entries takes more launches
    cap = ck.launch_cap("serve_order", 0)
    dispatches = delta("serve.dispatches") + sum(
        n * (-(-B // cap) - 1) for (B, _N), n in seen["serve_order"].items())
    serve_sum = sum(counts[k] for k in SERVE)
    log(f"phase 3d reads: 2 x {len(mix)} len reads (timed, profiled) + "
        f"{n_mixed} mixed, launches "
        f"{counts}, serve.dispatches {dispatches}, installs "
        f"{delta('serve.installs')}, memo_hits {delta('serve.memo_hits')}, "
        f"fallbacks {delta('serve.fallbacks')}, batches "
        f"{delta('serve.batches')}")
    for k in SERVE:
        if counts[k] == 0:
            raise AssertionError(f"kernel {k} never launched on the read path")
    if serve_sum != dispatches:
        raise AssertionError(
            f"serve launches {serve_sum} != serve.dispatches {dispatches} "
            "(with serve_order's extra launches)")
    if any(counts[k] != bulk[k] for k in BULK):
        raise AssertionError(f"bulk kernels launched during reads: {counts}")
    if delta("serve.fallbacks"):
        raise AssertionError("reads fell back to the host path")
    numbers = dict(
        qps=len(mix) / dt,
        p50_ms=quantile_ms(lat, 0.50),
        p99_ms=quantile_ms(lat, 0.99),
        p50_bucket_ms=hist_quantile_ms(hist.buckets, h0, h1, 0.50),
        p99_bucket_ms=hist_quantile_ms(hist.buckets, h0, h1, 0.99),
        host_qps=len(mix) / host_dt,
        host_p50_ms=quantile_ms(host_lat, 0.50),
        host_p99_ms=quantile_ms(host_lat, 0.99),
        profiled_qps=len(mix) / (prof["wall_ms"] / 1e3),
        device_busy_ms=prof["device_busy_ms"],
        device_idle_share=prof["device_idle_share"],
        open_s=t_open,
        batches=delta("serve.batches"),
    )
    log("phase 3d check: every answer == host_read; read mix " + " ".join(
        f"{k}={v!r}" for k, v in numbers.items()))
    shapes = {name: dict(seen[name]) for name in SERVE}
    log(f"phase 3d dispatch shapes (B, N): {shapes}")
    return counts, numbers, seen, last, urls, rows


def summary_rows(summ, doc_ids):
    """{doc id: the bytes of each summary array and its decoded counts}."""
    rows = {}
    for d in doc_ids:
        arrays, j = summ.arrays(d)
        rows[d] = tuple(
            arrays[k][j].tobytes()
            for k in ("map_winner", "elem_live", "elem_order",
                      "n_live_elems", "n_map_entries", "clock")
        ) + (repr(summ.doc(d)),)
    return rows


def time_order_dispatch(sk, devs, qobj, B, N):
    """serve_order's extra readings at one dispatch's inputs: the
    wrapper's host work (it ends in the dispatch's sync, so this is its
    wall), the copy back alone (device output into the thread's pinned
    buffer), the kernel alone cold, the bare torch.sort of a key already
    on the card (`library_ms`), and the like-for-like library dispatch
    (stack, key, stable torch.sort, order and counts to the host in one
    copy)."""
    import numpy as np
    import torch

    from hypermerge_tpu_torch.ops import crdt_kernels as ck

    dev = devs[0].device
    qo = torch.from_numpy(qobj).cuda()

    def key_of(st):
        mask = (st[:, 0] != 0) & (st[:, 2] == qo[:, None]) & (st[:, 3] == 1)
        return mask, torch.where(mask, -st[:, 1], 2**31 - 1)

    _mask, key = key_of(torch.stack(devs))

    def library_dispatch():
        mask, k = key_of(torch.stack(devs))
        order = torch.sort(k, dim=1, stable=True).indices.to(torch.int32)
        return torch.cat([order.flatten(),
                          mask.sum(dim=1, dtype=torch.int32)]).cpu()

    n_out = B * N + B
    out, host = ck.result_buffers.get(dev, n_out)
    r = dict(
        host_ms=host_call_ms(lambda: sk.seq_order_cuda(devs, qobj)),
        copy_back_ms=median_ms(
            lambda: host[:n_out].copy_(out[:n_out], non_blocking=True)),
        library_ms=median_ms(lambda: torch.sort(key, dim=1, stable=True)),
        library_dispatch_ms=median_ms(library_dispatch),
        cold_kernel_ms=None,
    )
    if N <= sk.ORDER_SHARED_KEYS:  # no scratch: the entry alone, no copy
        fn = ck.kernel_fn("serve_order")
        stream = ck.launch_stream(dev)

        def cold_order(_i):
            lanes = [d.clone() for d in devs]
            ptrs, q = sk.lane_pointers(lanes), qobj.copy()
            out_i = torch.empty(n_out, dtype=torch.int32, device=dev)

            def call():
                if fn(ptrs.ctypes.data, q.ctypes.data, B, N, 0, 0, None, 0,
                      out_i.data_ptr(), None, stream):
                    raise AssertionError("serve_order alone failed to launch")
                return lanes, out_i
            return call

        r["cold_kernel_ms"] = cold_calls_ms(cold_order)
    return r


def time_counts_dispatch(sk, devs, qobj, B, N):
    """serve_counts' extra readings at one dispatch's inputs: the
    wrapper's host work (it ends in the dispatch's sync, so this is its
    wall), the copy back alone (device output into the thread's pinned
    buffer), the kernel alone cold, and the like-for-like library
    dispatch (stack, the two masks, two sums, one cat, one copy to the
    host). No one PyTorch call computes the function: library_ms stays
    None."""
    import torch

    from hypermerge_tpu_torch.ops import crdt_kernels as ck

    dev = devs[0].device
    qo = torch.from_numpy(qobj).cuda()

    def library_dispatch():
        st = torch.stack(devs)
        at_obj = st[:, 2] == qo[:, None]
        elems = ((st[:, 0] != 0) & at_obj & (st[:, 3] == 1)).sum(
            dim=1, dtype=torch.int32)
        mapped = ((st[:, 5] != 0) & at_obj).sum(dim=1, dtype=torch.int32)
        return torch.cat([elems, mapped]).cpu()

    out, host = ck.result_buffers.get(dev, 2 * B)
    fn = ck.kernel_fn("serve_counts")
    stream = ck.launch_stream(dev)

    def cold_counts(_i):
        lanes = [d.clone() for d in devs]
        ptrs, q = sk.lane_pointers(lanes), qobj.copy()
        out_i = torch.empty(2 * B, dtype=torch.int32, device=dev)

        def call():  # the entry alone: no copy back, no sync
            if fn(ptrs.ctypes.data, q.ctypes.data, B, N, 0, out_i.data_ptr(),
                  None, stream):
                raise AssertionError("serve_counts alone failed to launch")
            return lanes, out_i
        return call

    return dict(
        host_ms=host_call_ms(lambda: sk.counts_cuda(devs, qobj)),
        copy_back_ms=median_ms(
            lambda: host[: 2 * B].copy_(out[: 2 * B], non_blocking=True)),
        library_dispatch_ms=median_ms(library_dispatch),
        cold_kernel_ms=cold_calls_ms(cold_counts),
    )


def time_lookup_dispatch(sk, devs, qobj, qkey, B, N):
    """serve_lookup's extra readings at one dispatch's inputs: the
    wrapper's host work (it ends in the dispatch's sync, so this is its
    wall), the copy back alone (device output into the thread's pinned
    buffer), the kernel alone cold, and the like-for-like library
    dispatch (stack, three compares, argmax, any, one copy to the host).
    No one PyTorch call computes the function: library_ms stays None."""
    import torch

    from hypermerge_tpu_torch.ops import crdt_kernels as ck

    dev = devs[0].device
    qo = torch.from_numpy(qobj).cuda()
    qk = torch.from_numpy(qkey).cuda()

    def library_dispatch():
        st = torch.stack(devs)
        mask = (st[:, 5] != 0) & (st[:, 4] == qk[:, None]) & (
            st[:, 2] == qo[:, None])
        row = torch.argmax(mask.to(torch.uint8), dim=1).to(torch.int32)
        return torch.cat([row, mask.any(dim=1).to(torch.int32)]).cpu()

    out, host = ck.result_buffers.get(dev, 2 * B)
    fn = ck.kernel_fn("serve_lookup")
    stream = ck.launch_stream(dev)

    def cold_lookup(_i):
        lanes = [d.clone() for d in devs]
        ptrs, qo_i, qk_i = sk.lane_pointers(lanes), qobj.copy(), qkey.copy()
        out_i = torch.empty(2 * B, dtype=torch.int32, device=dev)

        def call():  # the entry alone: no copy back, no sync
            if fn(ptrs.ctypes.data, qo_i.ctypes.data, qk_i.ctypes.data, B, N,
                  0, out_i.data_ptr(), None, stream):
                raise AssertionError("serve_lookup alone failed to launch")
            return lanes, out_i
        return call

    return dict(
        host_ms=host_call_ms(lambda: sk.map_lookup_cuda(devs, qobj, qkey)),
        copy_back_ms=median_ms(
            lambda: host[: 2 * B].copy_(out[: 2 * B], non_blocking=True)),
        library_dispatch_ms=median_ms(library_dispatch),
        cold_kernel_ms=cold_calls_ms(cold_lookup),
    )


def time_serve_kernels(sk, seen, last):
    """Phase 4 for the serve kernels, each at the (B, N) that the read
    slice dispatched most, on the lanes of one of those dispatches."""
    import numpy as np
    import torch

    res = {}
    kernel_names = {"serve_lookup": "lookup_kernel",
                    "serve_order": "order_kernel",
                    "serve_counts": "counts_kernel"}
    for name in SERVE:
        (B, N), n_calls = seen[name].most_common(1)[0]
        devs, qs = last[(name, (B, N))]
        qobj = qs[0]
        qkey = qs[1] if len(qs) > 1 else np.full(B, -1, np.int32)
        real = len({t.data_ptr() for t in devs})  # pad slots repeat entry 0
        lanes_read = {"serve_lookup": 3, "serve_order": 4, "serve_counts": 4}
        out_words = B * N + B if name == "serve_order" else 2 * B
        args_bytes = 8 * B * (1 + len(qs))
        r = dict(
            B=B, N=N, dispatches_at_shape=n_calls,
            ms=median_ms(lambda: serve_cuda(sk, name, devs, qobj, qkey)),
            kernel_ms=kernel_device_ms(
                lambda: serve_cuda(sk, name, devs, qobj, qkey),
                kernel_names[name]),
            plain_ms=median_ms(lambda: serve_plain(sk, name, devs, qobj, qkey)),
            library_ms=None,
            bytes=4 * lanes_read[name] * real * N + 4 * out_words + args_bytes,
            ops=(B * N * max(1, int(math.log2(N))) if name == "serve_order"
                 else lanes_read[name] * B * N),
        )
        if name == "serve_order":
            r.update(time_order_dispatch(sk, devs, qobj, B, N))
        if name == "serve_counts":
            r.update(time_counts_dispatch(sk, devs, qobj, B, N))
        if name == "serve_lookup":
            r.update(time_lookup_dispatch(sk, devs, qobj, qkey, B, N))
        t_bytes = r["bytes"] / MEM_BYTES_PER_S * 1e3
        t_ops = r["ops"] / SCALAR_OPS_PER_S * 1e3
        r["bound_ms"] = max(t_bytes, t_ops)
        r["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        log(f"timing {name} [B={B}, N={N}]: " + " ".join(
            f"{k}={v!r}" for k, v in r.items()))
        res[name] = r
    return res


# -- the multi-device slice -----------------------------------------------------


def virtual_ranks(n):
    import torch

    return [torch.device("cuda", 0)] * n


def compare_mesh_kernels(ringmod, meshmod, ckk):
    """Phase 2 for the multi-device slice: ring_gather against
    ring_gather_plain on virtual ranks of this card at every (n, rows, W)
    of RING_N x RING_ROWS x RING_W, and clock_union's min mode against
    min_reduce_plain; returns the max abs err per kernel."""
    import torch

    errs = dict.fromkeys(MESH, 0)
    g = torch.Generator(device="cuda").manual_seed(5)
    for n in RING_N:
        mesh = meshmod.make_mesh(n, devices=virtual_ranks(n))
        protocol = ringmod.Ring(mesh.devices, "protocol")
        for rows in RING_ROWS:
            for W in RING_W:
                blocks = [torch.randint(0, 256, (rows, W), generator=g,
                                        dtype=torch.uint8, device="cuda")
                          for _ in range(n)]
                want = ringmod.ring_gather_plain(blocks, mesh.devices)
                rings = [mesh.ring()]
                if rows in RING_PROTOCOL_ROWS and W in RING_PROTOCOL_W:
                    rings.append(protocol)
                for ring in rings:
                    got = ringmod.ring_gather_cuda(blocks, ring)
                    e = hold(f"ring_gather {ring.mode} n={n} [{rows}, {W}]",
                             tuple(got), tuple(want))
                    errs["ring_gather"] = max(errs["ring_gather"], e)
        if mesh.ring()._table is not None or protocol.epoch == 0:
            raise AssertionError("ring_gather: the virtual route made flags, "
                                 "or the flagged launch never ran")
    small, big = clock_matrix(5, 5, 3), clock_matrix(8, 8, 131072)
    for x in (small, big, -1 - small.abs(), -1 - big.abs()):
        e = hold(f"clock_union min {tuple(x.shape)}", ckk.min_reduce_cuda(x),
                 ckk.min_reduce_plain(x))
        errs["clock_union_min"] = max(errs["clock_union_min"], e)
    errs["clock_union_min"] = max(errs["clock_union_min"], hold_column_reduce(
        ckk.min_reduce_cuda, ckk.min_reduce_plain, "min"))
    log(f"phase 2 ring_gather at n in {RING_N} x rows in {RING_ROWS} x W in "
        f"{RING_W} (virtual ranks, push route; the flagged launch at rows in "
        f"{RING_PROTOCOL_ROWS} x W in {RING_PROTOCOL_W}), clock_union min at "
        f"[5, 3] and [8, 131072] (and negative): kernels == plain (exact)")
    return errs


def host_local_union(clock, doc_actors, n_actors):
    """The host twin of the scatter union: slot-local clocks maxed into
    global actor columns."""
    import numpy as np

    want = np.zeros(n_actors + 1, np.int64)
    da = np.asarray(doc_actors)
    np.maximum.at(want, np.where(da >= 0, da, n_actors).ravel(),
                  np.where(da >= 0, np.asarray(clock), 0).ravel())
    return want[:n_actors].astype(np.int32)


def mesh_references(ck, ckk, slab, multi):
    """The single-device answers phase 3e is held to, computed on the card
    before its counts are set to 0."""
    import numpy as np
    import torch

    ref = {}
    for lean in (False, True):
        ref["wire", lean] = ck.run_batch_full(slab, lean=lean)[1].cpu()
    single = ck.run_batch(multi)
    ref["lanes"] = {f: getattr(single, f).cpu().numpy() for f in LANES}
    da, _A, _K = ck.bucket_doc_actors(multi)
    ref["union"] = host_local_union(ref["lanes"]["clock"], da,
                                    len(multi.actors))
    n, A = CONFIG5["n_docs"], CONFIG5["n_actors"]
    clocks = np.random.default_rng(0).integers(1, 1000, size=(n, A),
                                               dtype=np.int32)
    query = np.full(A, 990, np.int32)
    m = torch.from_numpy(clocks).cuda()
    ref["config5"] = (clocks, query)
    ref["config5_union"] = ckk.union_reduce(m).cpu().numpy()
    ref["config5_dominated"] = ckk.gte(torch.from_numpy(query).cuda(),
                                       m).cpu().numpy()
    torch.cuda.synchronize()
    return ref


def mesh_path(ck, meshmod, sharded, slab, multi, ref, root, urls, rows,
              devices, label):
    """Phase 3e, the multi-device slice, on the ranks `devices` (virtual:
    one card repeated; peer: one card each): meshes (n, 1) and, for even
    n, (n/2, 2); each answer held equal to the single-device answer on
    the card. Counts set to 0 just before, read just after. Returns
    (counts, the real shape of the summary gather, the walls)."""
    import numpy as np
    import torch

    from hypermerge_tpu_torch.repo import Repo

    n = len(devices)
    meshes = [meshmod.make_mesh(n, devices=devices)]
    if n % 2 == 0:
        meshes.append(meshmod.make_mesh(n, sp=2, devices=devices))
    walls = {}

    def timed(name, fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t0
        return out

    for k in ck.launches:
        ck.launches[k] = 0
    t_phase = time.perf_counter()

    def full():
        for lean in (False, True):
            before = dict(ck.launches)
            _out, wire = sharded.sharded_full(slab, meshes[0], lean=lean)
            launched = {k: ck.launches[k] - before[k] for k in
                        ("materialize_wire", "materialize", "summary_wire")}
            if launched != {"materialize_wire": n, "materialize": 0,
                            "summary_wire": 0}:
                raise AssertionError(f"sharded_full lean={lean}: launches "
                                     f"{launched}, expected one a rank")
            if not torch.equal(wire.cpu()[: slab.n_docs], ref["wire", lean]):
                raise AssertionError(f"sharded_full lean={lean}: wire != "
                                     "run_batch_full's")

    timed("sharded_full_slab_s", full)

    def step():
        for mesh in meshes:
            out, union = sharded.step(multi, mesh)
            for f in LANES:
                got = np.asarray(getattr(out, f))[: multi.n_docs]
                if not np.array_equal(got, ref["lanes"][f]):
                    raise AssertionError(f"step {mesh}: lane {f} differs")
            if not np.array_equal(union.cpu().numpy(), ref["union"]):
                raise AssertionError(f"step {mesh}: union differs")

    timed("step_multi_s", step)

    def clock_queries():
        clocks, query = ref["config5"]
        for mesh in meshes:
            u = sharded.sharded_clock_union(clocks, mesh).cpu().numpy()
            d = sharded.sharded_dominated(clocks, query, mesh).cpu().numpy()
            if not np.array_equal(u, ref["config5_union"]):
                raise AssertionError(f"sharded_clock_union {mesh} differs")
            if not np.array_equal(d, ref["config5_dominated"]):
                raise AssertionError(f"sharded_dominated {mesh} differs")

    timed("config5_union_dominated_s", clock_queries)

    # the product route: Repo over the ranks, phase 3d's corpus in slabs
    # of MESH_SLAB docs. Serially (HM_PIPELINE=0) every slab is sharded;
    # its packed slabs are kept for the scheduler below. Pipelined (the
    # default where the native pack loads), whole slabs round-robin over
    # the ranks (MeshBulkScheduler, nothing tracked resident).
    batches = []
    orig_full = sharded.sharded_full

    def spy(batch, mesh, lean=False):
        batches.append(batch)
        return orig_full(batch, mesh, lean=lean)

    def product_open(pipelined):
        repo = Repo(path=root)
        try:
            def product():
                repo.open_many(urls)
                return repo.back.fetch_bulk_summaries()

            summ = timed(f"product_open_many_{pipelined}_s", product)
            got = summary_rows(summ, list(rows))
            return dict(repo.back.last_bulk_stats), got
        finally:
            repo.close()

    orig_visible = meshmod.visible_devices
    meshmod.visible_devices = lambda: list(devices)
    sharded.sharded_full = spy
    try:
        with env_vars(HM_BULK_SLAB=MESH_SLAB, HM_PIPELINE=0):
            stats, got = product_open("serial")
        sharded.sharded_full = orig_full
        with env_vars(HM_BULK_SLAB=MESH_SLAB, HM_PIPELINE=1):
            rr_stats, rr_got = product_open("pipelined")
    finally:
        sharded.sharded_full = orig_full
        meshmod.visible_devices = orig_visible
    if stats.get("sharded_slabs", 0) < 1 or stats["fast"] != len(urls):
        raise AssertionError(f"product route over {n} ranks: {stats}")
    if (rr_stats.get("rr_slabs", 0) < 1 or "sharded_slabs" in rr_stats
            or rr_stats["pipeline"] != 1
            or sum(rr_stats["slabs_per_chip"]) != rr_stats["rr_slabs"]
            or rr_stats["fast"] != len(urls)):
        raise AssertionError(f"pipelined product route over {n} ranks: "
                             f"{rr_stats}")
    for route, summaries in (("sharded", got), ("round-robin", rr_got)):
        bad = [d for d in rows if summaries[d] != rows[d]]
        if bad:
            raise AssertionError(f"product route ({route}): {len(bad)} "
                                 "summaries differ from the single-device "
                                 "Repo")

    # the mesh scheduler: the product's slabs round-robin over the ranks,
    # then the collective union and the summary gather
    def scheduler():
        sch = sharded.MeshBulkScheduler(meshes[0], track_resident=True)
        fetched = []
        n_actors = max(len(b.actors) for b in batches)
        union = np.zeros(n_actors, np.int32)
        for b in batches:
            out, wire = sch.dispatch(b, lean=False)
            fetched.append(wire.cpu().numpy())  # the per-slab fetch
            da, _A, _K = ck.bucket_doc_actors(b)
            union = np.maximum(union, host_local_union(
                out.clock.cpu().numpy(), da, n_actors))
        if not np.array_equal(sch.collective_clock_union(n_actors), union):
            raise AssertionError("collective_clock_union != host merge")
        gathered = sch.gather_summaries()
        if [g[0] for g in gathered] != list(range(len(batches))):
            raise AssertionError("gather_summaries out of dispatch order")
        for (_seq, _n, host), want in zip(gathered, fetched):
            if not np.array_equal(host, want):
                raise AssertionError("gather_summaries != per-slab fetch")
        per_chip = max(sum(1 for i in range(len(batches)) if i % n == c)
                       for c in range(n))
        return (n, per_chip * batches[0].n_docs, fetched[0].shape[1])

    gather_shape = timed("scheduler_s", scheduler)
    counts = dict(ck.launches)
    walls["phase_s"] = time.perf_counter() - t_phase
    log(f"phase 3e multi-device slice ({label}, {n} ranks, meshes "
        f"{[m.shape for m in meshes]}): walls {walls}; product route stats "
        f"{stats}; pipelined product route stats {rr_stats}; launches "
        f"{counts}")
    for k in ("ring_gather", "clock_union_min", "clock_union", "clock_pair",
              "clock_scatter", "materialize", "materialize_wire"):
        if counts[k] == 0:
            raise AssertionError(f"kernel {k} never launched in phase 3e")
    log(f"phase 3e check ({label}): sharded_full (full, lean) == "
        f"run_batch_full; step lanes and union == one device; config-5 union "
        f"and dominated == one device; {len(urls)} product summaries == the "
        f"single-device Repo, serially ({stats['sharded_slabs']} sharded "
        f"slabs) and pipelined ({rr_stats['rr_slabs']} round-robin slabs, "
        f"{rr_stats['slabs_per_chip']} a rank); scheduler union and gather "
        f"== per-slab fetches")
    return counts, gather_shape, walls


def cold_kernel_ms(make_call, footprint: int) -> float:
    """Device time per call in a stream of calls on memory of their own:
    make_call(i) gives the i-th of k calls on buffers of their own, k x
    `footprint` (the bytes one call reads and writes) at least 4 x the L2,
    and every call's result is kept until k calls later. The calls queue
    behind a spin of the card, then run back to back between two CUDA
    events (the gaps between launches count), so each reads its inputs
    from HBM and its writes evict the dirty lines of the calls before it.
    The stream moves at least 40 x the L2, so what the L2 holds at its
    ends is under 5% of it: a bytes bound at MEM_BYTES_PER_S holds for
    this time. Median of 3 streams after one to warm the allocator."""
    import collections
    import itertools

    import torch

    k = max(2, math.ceil(4 * L2_BYTES / footprint))
    runs = max(2 * k, math.ceil(40 * L2_BYTES / footprint))
    calls = itertools.cycle([make_call(i) for i in range(k)])
    held = collections.deque(maxlen=k)

    def stream():
        torch.cuda._sleep(runs * COLD_SLACK_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(runs):
            held.append(next(calls)())
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / runs

    stream()
    return statistics.median(stream() for _ in range(3))


def cold_calls_ms(make_call, count=256, slack=COLD_SLACK_CYCLES) -> float:
    """Device time per call of `count` calls each on memory of its own
    (make_call(i)), for calls too small for cold_kernel_ms's stream of 40
    x the L2: a 4 x L2 buffer is zeroed first (which evicts every line
    the calls' inputs held), the calls queue behind a spin of the card
    (`slack` cycles a call) and run back to back between two CUDA events,
    so each reads its inputs from HBM once. Median of 3 streams after one
    to warm."""
    import torch

    calls = [make_call(i) for i in range(count)]
    flush = torch.empty(4 * L2_BYTES, dtype=torch.uint8, device="cuda")

    def stream():
        flush.zero_()
        torch.cuda._sleep(count * slack)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for call in calls:
            call()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / count

    stream()
    return statistics.median(stream() for _ in range(3))


def time_mesh_kernels(ringmod, meshmod, ckk, gather_shape):
    """Phase 4 for the multi-device slice: ring_gather at the summary
    gather's real shape and at n = 4, 4096 x 1540 on virtual ranks (the
    wrapper, its host work, the kernel alone with cold inputs and outputs
    against the bound, and with its inputs in L2, the plain version, one
    torch.cat as the library call, the flagged launch over the same
    ranks), and the min mode at the config-5 pmin's fold ([2, 50000] on
    the (2, 2) mesh). Fails if the kernel alone, cold, is under its
    bound: then the bound does not hold."""
    import torch

    res = {}
    shapes = {"real": gather_shape, "n4_4096x1540": (4, 4096, 1540)}
    for label, (n, rows, W) in shapes.items():
        mesh = meshmod.make_mesh(n, devices=virtual_ranks(n))
        ring = mesh.ring()
        g = torch.Generator(device="cuda").manual_seed(n + rows)

        def make_blocks():
            return [torch.randint(0, 256, (rows, W), generator=g,
                                  dtype=torch.uint8, device="cuda")
                    for _ in range(n)]

        def cold_call(_i):
            bl = make_blocks()
            return lambda: ringmod.ring_gather_cuda(bl, ring)

        blocks = make_blocks()
        B = rows * W
        protocol = ringmod.Ring(mesh.devices, "protocol")
        r = dict(
            n=n, rows=rows, W=W, route=ring.mode,
            ms=median_ms(lambda: ringmod.ring_gather_cuda(blocks, ring),
                         HOST_BOUND_RUNS),
            host_ms=host_call_ms(lambda: ringmod.ring_gather_cuda(blocks, ring)),
            # n input blocks read once, one concatenation written once
            bytes=2 * n * B, ops=0,
            kernel_l2_ms=kernel_device_ms(
                lambda: ringmod.ring_gather_cuda(blocks, ring), "push_kernel"),
            plain_ms=median_ms(
                lambda: ringmod.ring_gather_plain(blocks, mesh.devices),
                HOST_BOUND_RUNS),
            # the flagged launch over the same virtual ranks (the peer
            # route's protocol on one card: n outputs), for comparison
            protocol_ms=median_ms(
                lambda: ringmod.ring_gather_cuda(blocks, protocol)),
            protocol_kernel_ms=kernel_device_ms(
                lambda: ringmod.ring_gather_cuda(blocks, protocol),
                "flagged_kernel"),
            library_ms=median_ms(lambda: torch.cat(blocks), HOST_BOUND_RUNS),
        )
        r["kernel_ms"] = cold_kernel_ms(cold_call, r["bytes"])
        r["bound_ms"] = r["bytes"] / MEM_BYTES_PER_S * 1e3
        r["bound_by"] = "bytes"
        r["bound_share"] = r["bound_ms"] / r["kernel_ms"]
        log(f"timing ring_gather {label} [n={n}, {rows}, {W}]: " + " ".join(
            f"{k}={v!r}" for k, v in r.items()))
        if r["kernel_ms"] < r["bound_ms"]:
            raise AssertionError(
                f"ring_gather {label}: the kernel alone ({r['kernel_ms']} ms, "
                f"cold) is under its bound ({r['bound_ms']} ms)")
        res[label] = r
    shape = (2, CONFIG5["n_docs"] // 2)
    m = clock_matrix(9, *shape, hi=2, inf_frac=0)
    out = ckk.min_reduce_cuda(m)

    def cold_min(i):
        x = clock_matrix(100 + i, *shape, hi=2, inf_frac=0)
        return lambda: ckk.min_reduce_cuda(x)

    r = dict(
        route="columns",
        ms=median_ms(lambda: ckk.min_reduce_cuda(m)),
        host_ms=host_call_ms(lambda: ckk.min_reduce_cuda(m)),
        # the one columns_kernel launch (D <= 64: no fill, no atomics)
        kernel_ms=kernel_device_ms(lambda: ckk.min_reduce_cuda(m),
                                   "columns_kernel"),
        cold_kernel_ms=cold_calls_ms(cold_min),
        plain_ms=median_ms(lambda: ckk.min_reduce_plain(m)),
        library_ms=median_ms(lambda: torch.amin(m, dim=0)),
        bytes=nbytes(m, out), ops=m.numel(),
    )
    r["library_ratio"] = r["ms"] / r["library_ms"]
    t_bytes = r["bytes"] / MEM_BYTES_PER_S * 1e3
    t_ops = r["ops"] / SCALAR_OPS_PER_S * 1e3
    r["bound_ms"] = max(t_bytes, t_ops)
    r["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    log(f"timing clock_union_min {list(m.shape)}: " + " ".join(
        f"{k}={v!r}" for k, v in r.items()))
    return {"ring_gather": res["real"], "clock_union_min": r,
            "ring_gather_n4": res["n4_4096x1540"]}


def time_peer_ring(ringmod, meshmod, cards):
    """Phase 4 for peer ranks (one card each; runs with two or more cards):
    ring_gather at n = len(cards), 512 x 1556 and 4096 x 1540 — the
    wrapper and the plain version by host clock around a synchronise of
    every card, the kernel alone on card 0 from the profiler, one
    Tensor.copy_ per block and rank (peer copies) as the library
    yardstick. Bound: each card receives n - 1 blocks over its NVLink at
    NVLINK_BYTES_PER_S."""
    import torch

    n = len(cards)
    mesh = meshmod.make_mesh(devices=cards)
    res = {}

    def sync_all():
        for d in cards:
            torch.cuda.synchronize(d)

    def host_ms(fn, runs=7, warmup=2):
        for _ in range(warmup):
            fn()
        sync_all()
        times = []
        for _ in range(runs):
            t0 = time.perf_counter()
            fn()
            sync_all()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    for rows, W in ((512, 1556), (4096, 1540)):
        g = torch.Generator().manual_seed(rows)
        blocks = [torch.randint(0, 256, (rows, W), generator=g,
                                dtype=torch.uint8).to(d) for d in cards]
        outs = [torch.empty(n * rows, W, dtype=torch.uint8, device=d)
                for d in cards]

        def copies():
            for o in outs:
                for b, blk in enumerate(blocks):
                    o[b * rows : (b + 1) * rows].copy_(blk)

        B = rows * W
        r = dict(
            n=n, rows=rows, W=W,
            ms=host_ms(lambda: ringmod.ring_gather_cuda(blocks, mesh.ring())),
            # the profiler's sum over the n cards' launches, per card
            kernel_ms_per_card=kernel_device_ms(
                lambda: ringmod.ring_gather_cuda(blocks, mesh.ring()),
                "flagged_kernel"),
            plain_ms=host_ms(
                lambda: ringmod.ring_gather_plain(blocks, mesh.devices)),
            library_ms=host_ms(copies),
            nvlink_bytes_per_card=(n - 1) * B,
        )
        if r["kernel_ms_per_card"] is not None:
            r["kernel_ms_per_card"] /= n
        r["bound_ms"] = (n - 1) * B / NVLINK_BYTES_PER_S * 1e3
        r["bound_by"] = "bytes (NVLink)"
        log(f"timing ring_gather peer [n={n}, {rows}, {W}]: " + " ".join(
            f"{k}={v!r}" for k, v in r.items()))
        res[rows, W] = r
    return res



# -- the live slice -------------------------------------------------------------


def live_columns(columnar, synth, n_ops, n_edits, seed, **kw):
    """One doc's LiveColumns as the live engine holds it: a synth history
    adopted from a packed batch, then a peer's `n_edits` live edits
    (synth_live_edits: a counter, INC ops, text deletes and inserts,
    conflicting sets) appended."""
    hist = synth.synth_changes(n_ops, seed=seed, **kw)
    lv = columnar.LiveColumns.from_batch(columnar.pack_docs([hist]), 0)
    lv.append_changes(synth.synth_live_edits(hist, n_edits, seed=seed))
    return lv


def live_tick_cases(columnar, synth):
    """{label: [LiveColumns]} of the live tick's two timed buckets: [1,
    262144] (one doc of LIVE_TRACE's size, one author) and [8, 32768]
    (8 docs of five authors)."""
    return {
        "1x262144": [live_columns(columnar, synth, LIVE_TRACE["n_ops"], 300,
                                  3, n_actors=1, ops_per_change=1,
                                  text_frac=1.0)],
        "8x32768": [live_columns(columnar, synth, 30000, 300, 40 + d,
                                 n_actors=5, n_keys=40, text_frac=0.5)
                    for d in range(8)],
    }


def live_args(ck, live, lvs, device, docs=None):
    """The padded tick batch `_kernel_device` builds for `lvs`, as tensors
    on `device`, with (A, K); `docs` cuts it to its first docs (the batch
    pads D to a power of two)."""
    import torch

    n = ck.live_bucket(max(lv.n for lv in lvs), ck.LIVE_MIN_ROWS)
    planes, A, K = live.tick_batch(lvs, n)
    return tuple(torch.from_numpy(a[:docs]).to(device) for a in planes), A, K


def doc_route_call(ck, args, A, K, route):
    """A call of the live tick's wrapper with doc_kernel.cu's route forced
    (ck.DOC_ROUTE_*): materialize_live_device's arguments, seq absent and
    a zero actor map."""
    import torch

    flags, slot, ctr, obj, key, ref, value, psrc, ptgt = args
    da = torch.zeros(flags.shape[0], A, dtype=torch.int32, device=flags.device)
    return lambda: ck.materialize_cuda(
        flags, slot, ctr, None, obj, key, ref, value, psrc, ptgt, da, A, K,
        counter="materialize_live", route=route)


def live_plain(ck, args, A, K):
    """materialize_live_device's plain version on the card: the plain
    doc kernel with seq absent and a zero actor map."""
    import torch

    flags, slot, ctr, obj, key, ref, value, psrc, ptgt = args
    da = torch.zeros(flags.shape[0], A, dtype=torch.int32, device=flags.device)
    return ck.doc_kernel_plain(
        *ck.widen_plain(flags, slot, ctr, None, obj, key, ref, value, psrc,
                        ptgt), da, A=A, K=K)


def compare_live_kernel(ck, live, columnar, synth):
    """Phase 2 for the live slice: materialize_live_device on the card
    against its plain version on the CPU, exact, on padded tick batches
    of seeded LiveColumns with INC ops and text, at (D, N) = (1, 262144)
    (A and K at their bucket floors) and (8, 32768) (A = 8, K = 64); at
    [3, 16384] (an odd D, cut from the padded batch) on both routes
    forced, byte-equal; and on both sides of each boundary of the entry's
    route rule: [1, 8192] (the longest doc whose scratch fits shared
    memory: one block a doc, in shared memory) and [1, 16384] (the
    many-block route); [SMs // 2, 16384] (the many-block route's largest
    D there; 8 distinct docs, repeated) and one doc more (one block a
    doc, its scratch in global lanes). Each case's route is held to the
    rule (`hm_doc_route`). Returns (max abs err, {label: (LiveColumns,
    args, A, K)} of the first two, {label: (args, A, K)} of every case)."""
    import torch

    half = torch.cuda.get_device_properties(0).multi_processor_count // 2
    pick = ck.kernel_fn("doc_route")

    def group(n_ops, seed):
        return [live_columns(columnar, synth, n_ops, 300, seed + d,
                             n_actors=2, n_keys=40, text_frac=0.6)
                for d in range(8)]

    g8, g16 = group(6000, 70), group(12000, 80)
    one, many = ck.DOC_ROUTE_ONE_BLOCK, ck.DOC_ROUTE_MANY_BLOCK
    expect = {"1x262144": many, "8x32768": many, "3x16384": many,
              "1x8192": one, "1x16384": many, f"{half}x16384": many,
              f"{half + 1}x16384": ck.DOC_ROUTE_ONE_BLOCK_GLOBAL}
    ticks = live_tick_cases(columnar, synth)
    cases = {
        "1x262144": (ticks["1x262144"], None),
        "8x32768": (ticks["8x32768"], None),
        "3x16384": ([live_columns(columnar, synth, 15000, 300, 50 + d,
                                  n_actors=3, n_keys=40, text_frac=0.6)
                     for d in range(3)], 3),
        "1x8192": (g8[:1], None),
        "1x16384": (g16[:1], None),
        f"{half}x16384": ((g16 * half)[:half], half),
        f"{half + 1}x16384": ((g16 * half)[:half + 1], half + 1),
    }
    err, inputs, every = 0, {}, {}
    for label, (lvs, docs) in cases.items():
        args, A, K = live_args(ck, live, lvs, "cuda", docs)
        every[label] = (args, A, K)
        if f"{args[0].shape[0]}x{args[0].shape[1]}" != label:
            raise AssertionError(f"live batch {label}: {list(args[0].shape)}")
        want_route = expect[label]
        picked = pick(*args[0].shape, ck.DOC_ROUTE_AUTO)
        if picked != want_route:
            raise AssertionError(f"live batch {label}: doc_kernel picks "
                                 f"route {picked}")
        got = ck.materialize_live_device(*args, A=A, K=K)
        cpu = tuple(a.cpu() for a in args)
        want = ck.materialize_live_device(*cpu, A=A, K=K)
        torch.cuda.synchronize()
        flags = args[0]
        if not ((flags & 7) == 6).any():  # Action.INC
            raise AssertionError(f"live batch {label} carries no INC op")
        e = hold(f"materialize_live {label}",
                 tuple(getattr(got, f) for f in LANES),
                 tuple(getattr(want, f).cuda() for f in LANES))
        if got.clock.any():
            raise AssertionError(f"materialize_live {label}: clock not zero")
        err = max(err, e)
        if label == "3x16384":  # both routes forced: the same bytes
            routes = [doc_route_call(ck, args, A, K, route)()
                      for route in (ck.DOC_ROUTE_ONE_BLOCK,
                                    ck.DOC_ROUTE_MANY_BLOCK)]
            for f in routes[0]._fields:
                if not torch.equal(getattr(routes[0], f),
                                   getattr(routes[1], f)):
                    raise AssertionError(f"doc_kernel routes differ at "
                                         f"{label} in {f}")
            err = max(err, hold(f"materialize_live {label} one-block route",
                                tuple(getattr(routes[0], f) for f in LANES),
                                tuple(getattr(want, f).cuda() for f in LANES)))
            log(f"phase 2 materialize_live {label}: one-block and many-block "
                "routes forced, byte-equal in every lane")
        if label in ("1x262144", "8x32768"):
            inputs[label] = (lvs, args, A, K)
        log(f"phase 2 materialize_live {list(flags.shape)} A={A} K={K} "
            f"(rows {sorted({lv.n for lv in lvs})}): kernel == plain (exact)")
    return err, inputs, every


def plain_value(v):
    """A frontend value as plain Python (Text and Counter by name)."""
    name = type(v).__name__
    if name == "Text":
        return ["__text__", str(v)]
    if name == "Counter":
        return ["__counter__", int(v)]
    if isinstance(v, dict):
        return {k: plain_value(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [plain_value(x) for x in v]
    return v


def drive_live(ck, root, urls, edits, chunk, device=None, tick_ms=None,
               min_cells=None):
    """The live slice through the entry points a user calls: a Repo on
    `root`, `open_many(urls)` (lazy docs) and `fetch_bulk_summaries`,
    each doc's first remote edit (adoption included, timed), then the
    rest of `edits[i]` through `apply_remote_changes` in chunks of
    `chunk`, every doc's chunk in turn (timed to the last tick's end).
    `tick_ms` raises the tick window (read when the engine is built);
    `min_cells` sets HM_DEVICE_MIN_CELLS (above the bucket: the engine's
    numpy twin route). Every tick's exception is kept and raised.
    Returns (per-doc outcome, numbers, the (D, N) of each device
    dispatch, one captured dispatch)."""
    import torch

    from hypermerge_tpu_torch.repo import Repo
    from hypermerge_tpu_torch.utils.ids import validate_doc_url

    env = {"HM_LIVE": "1", "HM_LIVE_TICK_MS": tick_ms,
           "HM_DEVICE_MIN_CELLS": min_cells}
    saved = {k: os.environ.get(k) for k in env}
    shapes, captured, errors = [], [], []
    orig = ck.materialize_live_device

    def spy(*args, A, K):
        out = orig(*args, A=A, K=K)
        shapes.append(tuple(args[0].shape))
        if not captured:
            captured.append((args, A, K, out))
        return out

    def sync():
        if torch.cuda.is_available():
            torch.cuda.synchronize()

    for k, v in env.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = str(v)
    ck.materialize_live_device = spy
    repo = Repo(path=root, device=device)
    try:
        back = repo.back
        eng = back.live
        if eng is None:
            raise AssertionError("the repo has no live engine")
        tick = eng._ticker._fn

        def guarded(batch):
            try:
                tick(batch)
            except BaseException as e:
                errors.append(e)
                raise

        eng._ticker._fn = guarded
        t0 = time.perf_counter()
        handles = repo.open_many(urls)
        back.fetch_bulk_summaries()
        for h in handles:
            if h.value(timeout=600) is None:
                raise AssertionError("a doc did not come up")
        open_s = time.perf_counter() - t0
        docs = [back.docs[validate_doc_url(u)] for u in urls]
        if any(d.opset is not None for d in docs):
            raise AssertionError("open_many built a host OpSet")
        t0 = time.perf_counter()
        for d, e in zip(docs, edits):
            d.apply_remote_changes(e[:1])
        if not eng.flush_now(600):
            raise AssertionError("the first edits' ticks did not finish")
        sync()
        first_ms = (time.perf_counter() - t0) * 1e3
        n_burst = sum(len(e) - 1 for e in edits)
        t0 = time.perf_counter()
        for base in range(1, max(len(e) for e in edits), chunk):
            for d, e in zip(docs, edits):
                if base < len(e):
                    d.apply_remote_changes(e[base:base + chunk])
        if not eng.flush_now(600):
            raise AssertionError("the burst's ticks did not finish")
        sync()
        burst_s = time.perf_counter() - t0
        peer = edits[0][0].actor
        for d, e in zip(docs, edits):
            if d.clock.get(peer, 0) != e[-1].seq:
                raise AssertionError(f"{d.id[:8]}: edits not all admitted")
        stats = dict(eng.stats)
        outcome = [
            (d.snapshot_patch().to_json(), dict(d.clock), d.history_len,
             plain_value(h.value(timeout=600)))
            for d, h in zip(docs, handles)
        ]
        if any(d.opset is not None for d in docs):
            raise AssertionError("a live doc fell to the host OpSet")
        if stats["refused"]:
            raise AssertionError(f"adoption refused: {stats}")
    finally:
        ck.materialize_live_device = orig
        repo.close()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    if errors:
        raise AssertionError(f"a live tick failed: {errors[0]!r}")
    numbers = dict(open_s=open_s, first_edit_ms=first_ms,
                   burst_edits=n_burst, burst_s=burst_s,
                   burst_edits_per_s=n_burst / burst_s, **stats)
    return outcome, numbers, shapes, captured


def write_live_corpus(root, n_docs, n_ops, ops_per_change, text_frac, seed):
    """A corpus for the live slice (set-up, untimed), its twin copy, and
    the docs' histories as the peers see them."""
    import shutil

    from hypermerge_tpu_torch.ops import synth
    from hypermerge_tpu_torch.ops.corpus import make_corpus

    urls = make_corpus(root, n_docs, n_ops, ops_per_change=ops_per_change,
                       seed=seed, sign=False, text_frac=text_frac)
    shutil.copytree(root, root + "-twin")
    hists = [synth.synth_changes(n_ops, n_actors=1,
                                 ops_per_change=ops_per_change,
                                 text_frac=text_frac, seed=seed + t)
             for t in range(min(n_docs, 8))]
    return urls, hists


def live_path(ck, root, device=None):
    """Phase 3f, the live slice. The trace doc: bench.py
    `_config6_text_trace`'s doc (one author, one op per change, 259,778
    ops, `synth_changes(..., text_frac=1.0, seed=3)`) written with its
    sidecar, opened lazily, then `_config6_live_burst`'s traffic — a
    peer's first edit, then 256 edits in chunks of 32; every tick over
    the increment budget runs at D = 1, N = 262144, over
    HM_DEVICE_MIN_CELLS, on the card. The group: 8 docs of 16,384 ops
    (`make_corpus`), each sent a 128-op chunk inside one raised tick
    window, so one dispatch runs at D = 8, N = 32768. Each run's launch
    counts are set to 0 just before it and read just after; each is
    replayed on a copy of its directory with HM_DEVICE_MIN_CELLS above
    the bucket (the numpy twin route), every doc's snapshot patch, clock,
    history length and frontend value identical; a captured tick batch
    is held against the plain version on the CPU. Returns (launches,
    numbers, the captured trace dispatch)."""
    from hypermerge_tpu_torch.ops import synth
    from hypermerge_tpu_torch.utils.ids import validate_doc_url

    t_phase = time.perf_counter()
    runs = {}
    for name, cfg in (("trace", LIVE_TRACE), ("group", LIVE_GROUP)):
        t0 = time.perf_counter()
        where = os.path.join(root, name)
        urls, hists = write_live_corpus(
            where, cfg["n_docs"], cfg["n_ops"], cfg["ops_per_change"],
            cfg["text_frac"], cfg["seed"])
        # the corpus stores each doc under its own writer actor
        edits = [synth.synth_live_edits(
            hists[i % len(hists)], 1 + cfg["edits"], seed=i,
            rename={"actor00": validate_doc_url(u)})
            for i, u in enumerate(urls)]
        log(f"phase 3f {name} corpus: {cfg['n_docs']} x {cfg['n_ops']} ops "
            f"written and {sum(map(len, edits))} peer edits made in "
            f"{time.perf_counter() - t0:.1f} s (set-up)")
        for k in ck.launches:
            ck.launches[k] = 0
        got, numbers, shapes, captured = drive_live(
            ck, where, urls, edits, cfg["chunk"], device=device,
            tick_ms=cfg["tick_ms"])
        counts = dict(ck.launches)
        for k in ck.launches:
            ck.launches[k] = 0
        want, twin, twin_shapes, _c = drive_live(
            ck, where + "-twin", urls, edits, cfg["chunk"], device=device,
            tick_ms=cfg["tick_ms"], min_cells=2**31 - 1)
        if ck.launches["materialize_live"] or twin_shapes:
            raise AssertionError(f"{name}: the twin route launched the kernel")
        for i, (g, w) in enumerate(zip(got, want)):
            for part, a, b in zip(("snapshot", "clock", "history", "value"),
                                  g, w):
                if a != b:
                    raise AssertionError(f"{name} doc {i}: {part} differs "
                                         "from the numpy twin route")
        if counts["materialize_live"] == 0 or not shapes:
            raise AssertionError(f"{name}: materialize_live never launched")
        if numbers["kernel_runs"] != numbers["device_dispatches"]:
            raise AssertionError(f"{name}: a kernel group above the cutover "
                                 f"took the numpy twin: {numbers}")
        if counts["materialize_live"] != numbers["device_dispatches"]:
            raise AssertionError(f"{name}: launches {counts} != dispatches")
        want_shape = (cfg["n_docs"], cfg["bucket"])
        if want_shape not in shapes:
            raise AssertionError(f"{name}: no {want_shape} dispatch: {shapes}")
        runs[name] = dict(counts=counts, numbers=numbers, twin=twin,
                          shapes=shapes, captured=captured[0])
        log(f"phase 3f {name} (device route): " + " ".join(
            f"{k}={v!r}" for k, v in numbers.items()))
        log(f"phase 3f {name} dispatches (D, N): {shapes}, launches "
            f"{ {k: v for k, v in counts.items() if v} }")
        log(f"phase 3f {name} (numpy twin route): " + " ".join(
            f"{k}={v!r}" for k, v in twin.items()))
    # one captured tick batch against the plain version on the CPU
    args, A, K, out = runs["trace"]["captured"]
    cpu = tuple(a.cpu() for a in args)
    want = ck.materialize_live_device(*cpu, A=A, K=K)
    hold(f"phase 3f captured tick {list(args[0].shape)}",
         tuple(getattr(out, f).cpu() for f in LANES),
         tuple(getattr(want, f) for f in LANES))
    wall = time.perf_counter() - t_phase
    launches = sum(r["counts"]["materialize_live"] for r in runs.values())
    log(f"phase 3f check: {launches} materialize_live launches (trace "
        f"{runs['trace']['counts']['materialize_live']}, group "
        f"{runs['group']['counts']['materialize_live']}), every doc's "
        f"snapshot, clock, history and value == the numpy twin route, the "
        f"captured [1, {LIVE_TRACE['bucket']}] tick == plain on the CPU; "
        f"phase wall {wall:.1f} s")
    numbers = {name: r["numbers"] for name, r in runs.items()}
    return launches, numbers, runs["trace"]["captured"]


def bench_open(ck, path, urls, doc_ids, route):
    """One cold open of the corpus at `path` (a fresh copy) under route
    `route` of OPEN_ROUTES: Repo(path), open_many + fetch_bulk_summaries,
    its launch counts set to 0 just before and read just after (and the
    host_args calls); returns (numbers, the summaries' rows)."""
    import torch

    from hypermerge_tpu_torch.repo import Repo

    with env_vars(HM_BULK_SLAB=BENCH_OPEN["slab"], **OPEN_ROUTES[route]):
        t0 = time.perf_counter()
        repo = Repo(path=path)
        t_repo = time.perf_counter() - t0
        try:
            for k in ck.launches:
                ck.launches[k] = 0

            def open_all():
                repo.open_many(urls)
                return repo.back.fetch_bulk_summaries()

            box = {}

            def timed():
                box["summ"] = open_all()

            def walled():
                t0 = time.perf_counter()
                timed()
                torch.cuda.synchronize()
                return dict(wall_ms=(time.perf_counter() - t0) * 1e3)

            numbers, host_args_calls = capture(ck, "host_args", walled)
            launches = {k: v for k, v in ck.launches.items() if v}
            stats = dict(repo.back.last_bulk_stats)
            t0 = time.perf_counter()
            rows = summary_rows(box["summ"], doc_ids)
            t_rows = time.perf_counter() - t0
        finally:
            t0 = time.perf_counter()
            repo.close()
            t_close = time.perf_counter() - t0
    # the host steps around the timed open
    numbers.update(t_repo_s=t_repo, t_rows_s=t_rows, t_close_s=t_close)
    numbers.update(route=route, launches=launches,
                   host_args=len(host_args_calls),
                   pipeline=stats["pipeline"], fast=stats["fast"],
                   **{k: stats.get(k) for k in OPEN_STATS})
    return numbers, rows


def pipeline_path(ck, root):
    """Phase 3g, the pipelined cold open at bench.py's primary shape:
    `make_corpus` writes BENCH_OPEN's docs x 1,024 ops once (no .sig, as
    in 3d); each route of OPEN_ROUTES opens a fresh copy of it once
    (bench_torch's `fresh_copy`: the database copied, the feed files
    hard-linked, since a full copy took 32-35 s a run on the card's
    host; the bench's `coldopen` cell traces route b's open, so no open
    here is profiled). Every open's summaries are byte-equal to the
    serial open's; pack_prefix launches once a slab on routes a and b
    and never on c, materialize_wire once a slab on every route, and
    host_args runs on route c alone; the pipeline stat is 1 on b and c.
    Returns (route b's launch counts, the numbers)."""
    import shutil

    from bench_torch.coldopen import fresh_copy
    from hypermerge_tpu_torch.ops.corpus import make_corpus
    from hypermerge_tpu_torch.utils.ids import validate_doc_url

    cfg = BENCH_OPEN
    src = os.path.join(root, "corpus")
    t0 = time.perf_counter()
    urls = make_corpus(src, cfg["n_docs"], cfg["n_ops"], sign=False)
    doc_ids = [validate_doc_url(u) for u in urls]
    slabs = -(-cfg["n_docs"] // cfg["slab"])
    log(f"phase 3g corpus: {cfg['n_docs']} x {cfg['n_ops']} ops written in "
        f"{time.perf_counter() - t0:.1f} s (set-up); {slabs} slabs of "
        f"{cfg['slab']}; os.cpu_count()={os.cpu_count()}")
    want_rows = None
    out, main_counts = [], None
    runs = list(OPEN_ROUTES)
    for route in runs:
        path = os.path.join(root, f"open-{route}")
        t0 = time.perf_counter()
        fresh_copy(src, path)
        t_copy = time.perf_counter() - t0
        t0 = time.perf_counter()
        numbers, rows = bench_open(ck, path, urls, doc_ids, route)
        t_run = time.perf_counter() - t0
        t0 = time.perf_counter()
        shutil.rmtree(path)
        numbers.update(t_copy_s=t_copy, t_run_s=t_run,
                       t_rmtree_s=time.perf_counter() - t0)
        if want_rows is None:
            want_rows = rows
        bad = sum(1 for d in doc_ids if rows[d] != want_rows[d])
        del rows
        launches = numbers["launches"]
        expect = {
            "pack_prefix": 0 if route == "c" else slabs,
            "materialize_wire": slabs,
        }
        if (bad or numbers["fast"] != cfg["n_docs"]
                or {k: launches.get(k, 0) for k in expect} != expect
                or numbers["host_args"] != (slabs if route == "c" else 0)
                or numbers["pipeline"] != (0 if route == "a" else 1)):
            raise AssertionError(f"phase 3g route {route}: {bad} "
                                 f"summaries differ; {numbers}")
        if route == "b":
            main_counts = dict(ck.launches)
        log(f"phase 3g open route {route}: " + json.dumps(numbers))
        out.append(numbers)
    log(f"phase 3g check: {len(runs)} opens, every summary == the serial "
        f"open's; pack_prefix {slabs} a route-a/b open and 0 on c, "
        f"materialize_wire {slabs} an open, host_args on route c alone")
    return main_counts, out


# the crash slice (phase 3h): bench.py `_config_crash` — a writer process
# of the port under HM_FSYNC=1 (the journal on, as by default) killed with
# SIGKILL after 150 durable acks, then its repo reopened on the card; the
# same kill inside a copy of phase 3d's corpus; and a recorded port
# workload cut by a simulated power cut at three prefixes
CRASH = dict(acks=150, child_timeout_s=300, powercut_edits=6)
CRASH_CHILD = r"""
import sys
sys.path.insert(0, sys.argv[2])
from hypermerge_tpu_torch.repo import Repo

repo = Repo(path=sys.argv[1])
url = repo.create({"edits": []})
print("URL", url, flush=True)
i = 0
while True:
    repo.change(url, lambda d, i=i: d["edits"].append(i))
    if repo.back.live is not None:
        repo.back.live.flush_now()
    repo.back.durability.flush_now()
    print("ACK", i, flush=True)  # durable under HM_FSYNC>=1
    i += 1
"""


def kill_writer(path: str) -> tuple:
    """Phase 3h (a): a child process runs the port's Repo(path) under
    HM_FSYNC=1, creates a doc and appends edits, printing each ack after
    the durability flusher settled; SIGKILL after CRASH["acks"] acks.
    Returns (the doc's url, the acks received)."""
    import signal
    import threading

    env = dict(os.environ, HM_FSYNC="1")
    root = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.Popen(
        [sys.executable, "-c", CRASH_CHILD, path, root],
        stdout=subprocess.PIPE, env=env, text=True,
    )
    # a child that stops acking is killed, and the phase fails below
    watchdog = threading.Timer(CRASH["child_timeout_s"], proc.kill)
    watchdog.start()
    url, acked = None, 0
    try:
        for line in proc.stdout:
            parts = line.split()
            if parts[:1] == ["URL"]:
                url = parts[1]
            elif parts[:1] == ["ACK"]:
                acked = int(parts[1]) + 1
                if acked >= CRASH["acks"]:
                    break
        # mid-burst hard kill: no atexit, no close(), no final flush
        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=30)
    finally:
        watchdog.cancel()
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        proc.stdout.close()
    if url is None or acked < CRASH["acks"]:
        raise AssertionError(f"phase 3h writer: url {url}, {acked} acks")
    return url, acked


def crash_counters(report: dict, acked: int, edits: list) -> dict:
    """The recovery's numbers, as bench.py `_config_crash` reports them,
    with the report's counters and its journal section."""
    from hypermerge_tpu_torch.storage import scrub

    byte_keys = ("bytes_truncated", "sig_fragment_bytes")
    wal = report.get("wal") or {}
    return dict(
        acked=acked,
        recovered_edits=len(edits),
        acked_lost=max(0, acked - len(edits)),
        blocks_truncated=report.get("tail_blocks_dropped", 0),
        bytes_truncated=report.get("bytes_truncated", 0),
        scrub_repairs=sum(report.get(k, 0) for k in scrub._COUNTERS
                          if k != "feeds" and k not in byte_keys),
        report={k: report.get(k, 0) for k in scrub._COUNTERS},
        feeds_skipped=report.get("feeds_skipped", 0),
        wal={k: wal.get(k) for k in ("present", "session_match", "tier",
                                     "records", "dirty_feeds", "replayed",
                                     "skipped", "torn_bytes", "bounded")},
    )


def check_edits(label: str, edits: list, acked: int) -> None:
    """A gapless prefix of the writer's edits that covers every ack."""
    if edits != list(range(len(edits))):
        raise AssertionError(f"{label}: not a gapless prefix: {edits[:20]}")
    if len(edits) < acked:
        raise AssertionError(f"{label}: {acked - len(edits)} acked edits lost")


def still_writable(repo, url: str, label: str) -> None:
    repo.change(url, lambda d: d["edits"].append(-1))
    deadline = time.monotonic() + 60
    while -1 not in (repo.doc(url) or {}).get("edits", []):
        if time.monotonic() > deadline:
            raise AssertionError(f"{label}: the recovered repo took no write")
        time.sleep(0.01)


def reopen_killed(path: str, url: str, acked: int) -> dict:
    """Phase 3h (b): Repo(path) on the card, timed until the killed
    writer's doc reads (t_recover_ms); recovery ran, its report was
    persisted, the doc holds every acked edit, and the repo takes a
    write."""
    from hypermerge_tpu_torch.repo import Repo
    from hypermerge_tpu_torch.storage import scrub

    t0 = time.perf_counter()
    repo = Repo(path=path)
    try:
        t_open_ms = (time.perf_counter() - t0) * 1e3
        report = repo.back.recovery_report
        edits = list(repo.open(url).value(timeout=60).get("edits", []))
        t_recover_ms = (time.perf_counter() - t0) * 1e3
        if report is None:
            raise AssertionError("phase 3h (b): recovery did not run")
        if scrub.last_report(path) is None:
            raise AssertionError("phase 3h (b): no persisted report")
        if repo.back.device.type != "cuda":
            raise AssertionError(f"phase 3h (b): on {repo.back.device}")
        check_edits("phase 3h (b)", edits, acked)
        still_writable(repo, url, "phase 3h (b)")
    finally:
        repo.close()
    return dict(t_recover_ms=t_recover_ms, t_repo_open_ms=t_open_ms,
                t_scrub_ms=report["t_recover_ms"],
                **crash_counters(report, acked, edits))


def crash_corpus_path(ck, root: str, urls: list, rows: dict) -> dict:
    """Phase 3h (c): (a)'s kill inside a copy of phase 3d's corpus, then
    Repo(path) on the card: the journal's ledger bounds the scan
    (feeds_skipped >= the corpus's feeds less the writer's dirty ones)
    and the writer's doc holds every ack (t_recover_ms: Repo(path) until
    it reads); then open_many + fetch_bulk_summaries over the corpus (the
    pipelined default route), launch counts set to 0 before the open and
    read after it: pack_prefix and materialize_wire once a slab, every
    summary byte-equal to phase 3d's open before the kill;
    then the own-repo ClockStore's union and dominated through the mirror
    on the card == numpy over the sqlite rows recovery left."""
    import numpy as np
    import torch

    from hypermerge_tpu_torch.repo import Repo
    from hypermerge_tpu_torch.storage import scrub
    from hypermerge_tpu_torch.utils.ids import validate_doc_url

    n_feeds = len(scrub.feed_names_on_disk(os.path.join(root, "feeds")))
    url, acked = kill_writer(root)
    doc_ids = [validate_doc_url(u) for u in urls]
    t0 = time.perf_counter()
    repo = Repo(path=root)
    try:
        back = repo.back
        t_repo_open_ms = (time.perf_counter() - t0) * 1e3
        report = back.recovery_report
        if report is None:
            raise AssertionError("phase 3h (c): recovery did not run")
        wal = report["wal"]
        skipped = report.get("feeds_skipped", 0)
        if not wal["bounded"] or skipped < n_feeds - wal["dirty_feeds"]:
            raise AssertionError(f"phase 3h (c): the scan was not bounded: "
                                 f"{n_feeds} feeds, {skipped} skipped, "
                                 f"wal {wal}")
        edits = list(repo.open(url).value(timeout=60).get("edits", []))
        t_recover_ms = (time.perf_counter() - t0) * 1e3
        check_edits("phase 3h (c)", edits, acked)

        for k in ck.launches:
            ck.launches[k] = 0
        t1 = time.perf_counter()
        repo.open_many(urls)
        summ = back.fetch_bulk_summaries()
        torch.cuda.synchronize()
        t_open_many_ms = (time.perf_counter() - t1) * 1e3
        launches = {k: ck.launches[k] for k in BULK}
        stats = dict(back.last_bulk_stats)
        slabs = math.ceil(len(urls) / 4096)
        if any(v != slabs for v in launches.values()):
            raise AssertionError(f"phase 3h (c): bulk kernels {launches}, "
                                 f"expected {slabs} each; stats {stats}")
        got = summary_rows(summ, doc_ids)
        bad = sum(1 for d in doc_ids if got[d] != rows[d])
        if bad:
            raise AssertionError(f"phase 3h (c): {bad} summaries differ "
                                 "from the open before the kill")

        # the own-repo clock store through the mirror, against numpy
        back._stores.flush_now()
        for k in ck.launches:
            ck.launches[k] = 0
        union = back.clocks.union_query(back.id)
        sql_rows = back.db.query(
            "SELECT doc_id, actor_id, seq FROM clocks WHERE repo_id=?",
            (back.id,))
        docs = sorted({d for d, _a, _s in sql_rows})
        actors = sorted({a for _d, a, _s in sql_rows})
        di = {d: i for i, d in enumerate(docs)}
        ai = {a: j for j, a in enumerate(actors)}
        mat = np.zeros((len(docs), len(actors)), np.int64)
        for d, a, s in sql_rows:
            mat[di[d], ai[a]] = s
        want_union = {a: int(v) for a, v in zip(actors, mat.max(axis=0))
                      if v > 0}
        if union != want_union:
            raise AssertionError("phase 3h (c): mirror union != sqlite")
        # a query that splits the docs: the union over the first half of
        # the actors (most docs have one actor of their own), one less
        # than it on every third of those, 0 on the rest
        half = len(actors) // 2
        qrow = np.zeros(len(actors), np.int64)
        qrow[:half] = mat.max(axis=0)[:half]
        qrow[:half:3] -= 1
        query = {a: int(v) for a, v in zip(actors, qrow)}
        dominated = back.clocks.dominated_query(back.id, query)
        want_dom = sorted(d for d in docs
                          if (mat[di[d]] <= qrow).all())
        if sorted(dominated) != want_dom or not want_dom:
            raise AssertionError(
                f"phase 3h (c): mirror dominated {len(dominated)} docs != "
                f"sqlite's {len(want_dom)}")
        # the scatter runs where the mirror still buffers writes
        clock_launches = {k: ck.launches[k] for k in
                          ("clock_scatter", "clock_union", "clock_pair")}
        if min(clock_launches["clock_union"], clock_launches["clock_pair"]) < 1:
            raise AssertionError(f"phase 3h (c): the clock queries did not "
                                 f"run on the mirror: {clock_launches}")
        still_writable(repo, url, "phase 3h (c)")
    finally:
        repo.close()
    return dict(t_recover_ms=t_recover_ms, t_repo_open_ms=t_repo_open_ms,
                t_scrub_ms=report["t_recover_ms"],
                t_open_many_ms=t_open_many_ms, n_feeds=n_feeds,
                docs=len(urls), launches=launches,
                clock_launches=clock_launches, clock_docs=len(docs),
                clock_actors=len(actors), dominated=len(want_dom),
                **crash_counters(report, acked, edits))


def powercut_path(root: str) -> dict:
    """Phase 3h (d): a CrashRecorder over a port workload at HM_FSYNC=1
    (one doc, an edit acked after each durability flush), three prefixes
    materialized under powercut=True and each reopened on the card: the
    journal replays (storage.wal.replayed above 0 on at least one) and
    no acked edit is lost."""
    from hypermerge_tpu_torch import telemetry
    from hypermerge_tpu_torch.repo import Repo
    from hypermerge_tpu_torch.storage import faults

    work = os.path.join(root, "work")
    rec = faults.CrashRecorder(work)
    acked = []
    with env_vars(HM_FSYNC="1"):
        with faults.activate(recorder=rec):
            repo = Repo(path=work)
            url = repo.create({"edits": []})
            for i in range(CRASH["powercut_edits"]):
                repo.change(url, lambda d, i=i: d["edits"].append(i))
                repo.back.live.flush_now()
                repo.back._stores.flush_now()
                repo.back.durability.flush_now()  # the durable ack
                acked.append((len(rec.events), i + 1))
        repo.close()  # after the recording: the cut is in its events
        points = [acked[0], acked[len(acked) // 2], acked[-1]]
        out = []
        for k, want in points:
            dst = os.path.join(root, f"cut{k}")
            rec.materialize(dst, k, powercut=True)
            replayed0 = telemetry.snapshot().get("storage.wal.replayed", 0)
            t0 = time.perf_counter()
            repo = Repo(path=dst)
            try:
                edits = list(repo.open(url).value(timeout=60)
                             .get("edits", []))
                t_ms = (time.perf_counter() - t0) * 1e3
                report = repo.back.recovery_report
                if report is None:
                    raise AssertionError(f"phase 3h (d) cut {k}: no recovery")
                check_edits(f"phase 3h (d) cut {k}", edits, want)
            finally:
                repo.close()
            replayed = (telemetry.snapshot().get("storage.wal.replayed", 0)
                        - replayed0)
            out.append(dict(event=k, of=len(rec.events), acked=want,
                            recovered_edits=len(edits),
                            acked_lost=max(0, want - len(edits)),
                            replayed=replayed, t_recover_ms=t_ms))
    if not any(p["replayed"] > 0 for p in out):
        raise AssertionError(f"phase 3h (d): the journal never replayed {out}")
    return dict(prefixes=out)


def crash_path(ck, root: str, corpus: str, urls: list, rows: dict) -> dict:
    """Phase 3h: (a) + (b) in an empty directory, (c) in `corpus` (a copy
    of phase 3d's corpus), (d) the power cuts. Returns the numbers."""
    card = card_line()
    empty = os.path.join(root, "empty")
    os.makedirs(empty)
    url, acked = kill_writer(empty)
    b = reopen_killed(empty, url, acked)
    log(f"phase 3h (b) kill after {acked} acks, reopen on the card: "
        + json.dumps(b) + f" [{card}]")
    c = crash_corpus_path(ck, corpus, urls, rows)
    log(f"phase 3h (c) kill inside phase 3d's corpus, reopen + open_many on "
        f"the card: " + json.dumps(c) + f" [{card}]")
    d = powercut_path(os.path.join(root, "powercut"))
    log("phase 3h (d) power cuts reopened on the card: " + json.dumps(d)
        + f" [{card}]")
    log(f"phase 3h check: recovery ran, acked_lost 0 ({b['acked_lost']}, "
        f"{c['acked_lost']}, {[p['acked_lost'] for p in d['prefixes']]}), "
        f"feeds_skipped {c['feeds_skipped']} of {c['n_feeds']}, every "
        f"corpus summary == the open before the kill, pack_prefix / "
        f"materialize_wire {c['launches']}, the mirror's union/dominated "
        f"== sqlite's rows, the journal replayed on a power cut")
    return dict(card=card, kill=b, corpus=c, powercut=d)


# the network slice (phase 3i): (a) BASELINE configs[1] as bench.py's
# _config2_convergence sends it (2 repos x 10 docs, 50 rounds of appends on
# A and, every fifth round, on B, over TcpSwarm), once at the engine's
# defaults and once with the live cutovers at 0 and a 500 ms tick window,
# so that B's ticks of more than 8 ops take the kernel. Both runs close with
# a paste: one change a doc on A that appends NET["paste"] edits. Without
# it, whether B ever ticks more than 8 ops depends on delivery timing: when
# delivery keeps up with A, B's own edits every fifth round catch each doc
# up 5 changes at a time inline, and the kernel route launched nothing (seen
# on the card). A change of 16 ops takes the kernel wherever it lands;
# (b) a late replica
# pulling a signed corpus of phase 3d's shape over TcpSwarm, then reopened.
# The pull's doc count is cut from 3d's 2,048 to 32: without libsodium on
# the card's host the transport runs utils/chacha.py (about 1 MB/s) and the
# corpus signs in pure Python, about 0.6 s and 0.4 s a doc there (128 docs
# until phase 3j joined the script and pushed it past 750 s of its 1,200;
# 64 until phase 3k joined it)
NET = dict(n_docs=10, n_edits=50, paste=16, pull_docs=32, pull_ops=1024,
           timeout_s=300)
NET_KERNEL_ENV = dict(HM_LIVE_INC_BUDGET="0", HM_DEVICE_MIN_CELLS="0",
                      HM_LIVE_TICK_MS="500")


def live_stats(repo) -> dict:
    """bench.py `_live_stats` for one repo: the live engine's stats, with
    docs and changes a tick."""
    out = {k: round(v, 6) for k, v in repo.back.live.stats.items()}
    if out.get("ticks"):
        out["docs_per_tick"] = round(out["tick_docs"] / out["ticks"], 2)
        out["changes_per_tick"] = round(out["tick_changes"] / out["ticks"],
                                        2)
    return out


def net_counters() -> dict:
    """The process's net.* telemetry counters (frames and bytes on the
    wire, replication frames, cursor gossip)."""
    from hypermerge_tpu_torch import telemetry

    return {k: v for k, v in telemetry.snapshot().items()
            if k.startswith("net.")}


def transport_crypto() -> str:
    """Which X25519 / ChaCha20-Poly1305 net/secure.py runs: the native
    library's libsodium entries, else utils/chacha.py."""
    from hypermerge_tpu_torch import native

    if native.x25519_base(b"\x09" * 32) is not None:
        return "native libsodium"
    return "chacha (pure Python)"


def wait_for(what: str, fn, timeout_s: float, phase: str = "3i") -> float:
    """Poll fn until it is true; the seconds it took. Raises after
    timeout_s."""
    t0 = time.perf_counter()
    while not fn():
        if time.perf_counter() - t0 > timeout_s:
            raise AssertionError(f"phase {phase}: {what} not within "
                                 f"{timeout_s} s")
        time.sleep(0.01)
    return time.perf_counter() - t0


def check_pinned(ra, rb, label: str, phase: str = "3i") -> None:
    """Each side's connection to the other is encrypted and authenticated:
    the transport-proven identity is the other repo's id."""
    for me, other in ((ra, rb), (rb, ra)):
        (peer,) = me.back.network.peers.values()
        if peer.connection.peer_identity != other.back.id:
            raise AssertionError(f"phase {phase} {label}: the connection is "
                                 "not authenticated as the other repo")


def held_changes(repo, url: str) -> list:
    """Every change `repo` holds of a doc: each actor's feed up to the
    doc's clock."""
    from hypermerge_tpu_torch.utils.ids import validate_doc_url

    back = repo.back
    clock = back.docs[validate_doc_url(url)].clock
    out = []
    for actor_id, seq in clock.items():
        out.extend(back._get_or_create_actor(actor_id).changes_in_window(
            0, seq))
    return out


def config2_run(ck, label: str, env: dict, device=None) -> dict:
    """Phase 3i (a), one run: BASELINE configs[1] between two port repos on
    the card over encrypted, authenticated TcpSwarm (bench.py
    `_config2_run`) and then A's paste (one change a doc appending
    NET["paste"] edits), the launch counts set to 0 just before the edits
    and read after both sides converged. Every doc on B holds all 76 edits
    and equals A's, and each side's value equals the plain replay of the
    changes it holds (bench_torch/reference.py `replay_value`, which
    orders the list by the RGA rule without the program's engines or
    kernels). Returns the numbers."""
    from bench_torch.reference import replay_value
    import torch

    from hypermerge_tpu_torch.net.tcp import TcpSwarm
    from hypermerge_tpu_torch.repo import Repo

    cfg = NET

    def paste(d):
        for j in range(cfg["paste"]):
            d["edits"].append(2000 + j)

    with env_vars(**env):
        ra = Repo(memory=True, device=device)
        rb = Repo(memory=True, device=device)
        sa, sb = TcpSwarm(), TcpSwarm()
        try:
            for r in (ra, rb):
                if device is None and r.back.device.type != "cuda":
                    raise AssertionError(f"phase 3i: on {r.back.device}")
            ra.set_swarm(sa)
            rb.set_swarm(sb)
            sb.connect(sa.address)
            urls = [ra.create({"edits": []}) for _ in range(cfg["n_docs"])]
            handles = [rb.open(u) for u in urls]
            for h in handles:
                h.value(timeout=cfg["timeout_s"])
            check_pinned(ra, rb, label)
            net0 = net_counters()
            for k in ck.launches:
                ck.launches[k] = 0
            t0 = time.perf_counter()
            n = cfg["n_edits"]
            for i in range(n):
                for u in urls:
                    ra.change(u, lambda d, i=i: d["edits"].append(i))
                if i % 5 == 0:
                    for h in handles:
                        h.change(lambda d, i=i: d["edits"].append(1000 + i))
            for u in urls:
                ra.change(u, paste)
            want = n + (n + 4) // 5 + cfg["paste"]
            t_b = wait_for("B's convergence", lambda: all(
                len((h.value() or {}).get("edits", [])) >= want
                for h in handles), cfg["timeout_s"])
            wait_for("A's convergence", lambda: all(
                len(ra.doc(u)["edits"]) >= want for u in urls),
                cfg["timeout_s"])
            wall = time.perf_counter() - t0
            if device is None:
                torch.cuda.synchronize()
            launches = {k: v for k, v in ck.launches.items() if v}
            bad = [u for u in urls if ra.doc(u) != rb.doc(u)
                   or len(rb.doc(u)["edits"]) != want]
            if bad:
                raise AssertionError(f"phase 3i {label}: {len(bad)} docs "
                                     "differ between A and B")
            unplain = [(side, u) for side, r in (("A", ra), ("B", rb))
                       for u in urls if plain_value(r.doc(u))
                       != replay_value(held_changes(r, u))]
            if unplain:
                raise AssertionError(f"phase 3i {label}: {len(unplain)} "
                                     "docs differ from the plain replay of "
                                     f"their changes: {unplain[:4]}")
            stats = {"a": live_stats(ra), "b": live_stats(rb)}
            repl = {"a": ra.back.network.replication.stats,
                    "b": rb.back.network.replication.stats}
        finally:
            ra.close()
            rb.close()
            sa.destroy()
            sb.destroy()
    net1 = net_counters()
    return dict(
        label=label, env=env, docs=cfg["n_docs"], edits_a_doc=want,
        wall_s=wall, b_converged_s=t_b, launches=launches, live=stats,
        replication=repl,
        net={k: v - net0.get(k, 0) for k, v in net1.items()},
    )


def pull_path(ck, root: str) -> dict:
    """Phase 3i (b): a late replica pulls a corpus. A holds a signed
    corpus of phase 3d's shape (NET["pull_docs"] single-writer docs x
    1,024 ops, `make_corpus`) in `Repo(path)` on the card and opens it
    (its own open: the summaries B is held to). B, a fresh `Repo(path)`
    on the card, joins over TcpSwarm and opens every doc's url
    (`open_many`: no writer actor is minted, so the docs stay
    single-writer); replication pulls every feed in signed chunks until
    each doc's clock covers its 64 changes. Then B is closed and
    reopened, and `open_many` + `fetch_bulk_summaries` runs on the card
    with the launch counts set to 0 just before and read just after:
    pack_prefix and materialize_wire launched, every summary byte-equal
    to A's open. Returns the numbers."""
    import torch

    from hypermerge_tpu_torch.net.tcp import TcpSwarm
    from hypermerge_tpu_torch.ops.corpus import make_corpus
    from hypermerge_tpu_torch.repo import Repo
    from hypermerge_tpu_torch.utils.ids import validate_doc_url

    cfg = NET
    n, n_ops = cfg["pull_docs"], cfg["pull_ops"]
    n_changes = n_ops // 16  # make_corpus's 16 ops a change
    src, dst = os.path.join(root, "a"), os.path.join(root, "b")
    t0 = time.perf_counter()
    urls = make_corpus(src, n, n_ops, sign=True)
    t_corpus = time.perf_counter() - t0
    ids = [validate_doc_url(u) for u in urls]
    ra = Repo(path=src)
    rb = None
    sa, sb = TcpSwarm(), TcpSwarm()
    try:
        ra.open_many(urls)
        want = summary_rows(ra.back.fetch_bulk_summaries(), ids)
        ra.set_swarm(sa)
        rb = Repo(path=dst)
        rb.set_swarm(sb)
        sb.connect(sa.address)
        net0 = net_counters()
        t0 = time.perf_counter()
        rb.open_many(urls)
        rb.back.fetch_bulk_summaries()

        def pulled():
            docs = rb.back.docs
            return all(
                d in docs and sum(docs[d].clock.values()) >= n_changes
                for d in ids)

        t_pull = wait_for("the pull", pulled, cfg["timeout_s"])
        check_pinned(ra, rb, "(b)")
        repl = {"a": ra.back.network.replication.stats,
                "b": rb.back.network.replication.stats}
        live_b = live_stats(rb)
    finally:
        if rb is not None:
            rb.close()
        ra.close()
        sa.destroy()
        sb.destroy()
    net1 = net_counters()
    for k in ck.launches:
        ck.launches[k] = 0
    t0 = time.perf_counter()
    rb = Repo(path=dst)
    try:
        rb.open_many(urls)
        rows = summary_rows(rb.back.fetch_bulk_summaries(), ids)
        torch.cuda.synchronize()
        t_reopen = time.perf_counter() - t0
        launches = {k: v for k, v in ck.launches.items() if v}
        stats = dict(rb.back.last_bulk_stats)
    finally:
        rb.close()
    bad = sum(1 for d in ids if rows[d] != want[d])
    if bad or stats.get("fast") != n:
        raise AssertionError(f"phase 3i (b): {bad} summaries differ from A's "
                             f"open; stats {stats}")
    for k in BULK:
        if not launches.get(k):
            raise AssertionError(f"phase 3i (b): {k} never launched in the "
                                 f"reopen: {launches}")
    return dict(
        docs=n, ops_a_doc=n_ops, signed=True, t_corpus_s=t_corpus,
        t_pull_s=t_pull, t_reopen_s=t_reopen, launches=launches,
        replication=repl, live_b=live_b,
        net={k: v - net0.get(k, 0) for k, v in net1.items()},
        reopen_stats={k: stats.get(k) for k in ("docs", "fast", "pipeline",
                                                "t_io", "t_pack")},
    )


def net_path(ck, root: str) -> dict:
    """Phase 3i: (a) config 2 at the defaults, then over the live
    cutovers (materialize_live must launch on the card); (b) the pull.
    Returns (the launch counts of (a)'s kernel run and (b)'s reopen
    summed, the numbers)."""
    card = card_line()
    crypto = transport_crypto()
    runs = [config2_run(ck, "defaults", {}),
            config2_run(ck, "kernel route", NET_KERNEL_ENV)]
    for r in runs:
        log(f"phase 3i (a) config 2 {r['label']}: " + json.dumps(r)
            + f" [{card}]")
    if not runs[1]["launches"].get("materialize_live"):
        raise AssertionError("phase 3i (a): materialize_live never launched "
                             f"on the card: {runs[1]['launches']}")
    pull = pull_path(ck, root)
    log("phase 3i (b) pull + reopen: " + json.dumps(pull) + f" [{card}]")
    counts = dict(runs[1]["launches"])
    for k, v in pull["launches"].items():
        counts[k] = counts.get(k, 0) + v
    log(f"phase 3i check: config 2 converged at the defaults in "
        f"{runs[0]['wall_s']:.3f} s and over the kernel route in "
        f"{runs[1]['wall_s']:.3f} s (materialize_live "
        f"{runs[1]['launches'].get('materialize_live')}), every doc equal "
        f"on both sides and to the plain replay; {pull['docs']} docs pulled in "
        f"{pull['t_pull_s']:.3f} s and reopened in {pull['t_reopen_s']:.3f} "
        f"s, every summary == A's open, {pull['launches']}; transport "
        f"crypto: {crypto}; connections authenticated")
    return counts, dict(card=card, crypto=crypto, config2=runs, pull=pull)


# the churn slice (phase 3j): (a) bench.py `_config_churn` uncut — two card
# repos over TcpSwarm, B's swarm a FaultSwarm whose seeded plan kills and
# heals the link twice in the burst, on the thread stack and on the shared
# loop (HM_NET_ASYNC=1); (b) the same shape on the loop under HM_FAULT, which
# wraps both swarms and ticks them on a wall clock; (c) bench.py
# `_config_swarm`, cut from its 16 repos to FLEET["n_peers"] (16 until
# phase 3k joined the script: the join's Python crypto took 58-87 s at 16),
# joined through one DHT node alone, the n // 5 churned ones killed and
# healed in the burst. All under the
# live cutovers of phase 3i, so remote ticks of more than 8 ops (the bursts
# after a resync) take the kernel
CHURN = dict(n_docs=6, n_edits=40, seed=10, timeout_s=120,
             events=[(1, "kill"), (2, "heal"), (3, "kill"), (4, "heal")])
CHURN_ENV = dict(HM_REDIAL_BASE_MS="50", HM_REDIAL_MAX_S="1")
HM_FAULT_SPEC = "seed=3,kill@4,heal@7,tick=50"
FLEET = dict(n_peers=10, n_edits=24, fanout=4, seed=19, join_timeout_s=120,
             timeout_s=180)
FLEET_ENV = dict(HM_REDIAL_BASE_MS="50", HM_REDIAL_MAX_S="1",
                 HM_DHT_ANNOUNCE_S="0.5", HM_DHT_LOOKUP_S="0.5",
                 HM_GOSSIP_FANOUT=str(FLEET["fanout"]),
                 HM_GOSSIP_RESHUFFLE_S="0.5", HM_NET_PING_S="0")


def check_replay(label: str, repos, urls) -> None:
    """Every repo's value of every doc equals the plain replay of the
    changes it holds (bench_torch/reference.py `replay_value`)."""
    from bench_torch.reference import replay_value

    bad = [(i, u) for i, r in enumerate(repos) for u in urls
           if plain_value(r.doc(u)) != replay_value(held_changes(r, u))]
    if bad:
        raise AssertionError(f"phase 3j {label}: {len(bad)} values differ "
                             f"from the plain replay of their changes: "
                             f"{bad[:4]}")


def on_card(label: str, repos) -> None:
    for r in repos:
        if r.back.device.type != "cuda":
            raise AssertionError(f"phase 3j {label}: on {r.back.device}")


def churn_run(ck, label: str, env: dict) -> dict:
    """Phase 3j (a) or (b), one run: `_config_churn`'s burst (A appends to
    each doc every round, B every fifth) between two card repos over
    encrypted, authenticated TcpSwarm. Without HM_FAULT in `env`, B's
    swarm is a FaultSwarm with CHURN's plan, ticked at each quarter of the
    burst and then healed; with it, Network wraps both swarms and their
    tickers run the spec. The launch counts are set to 0 just before the
    burst and read after both sides converged. Every doc holds 48 edits on
    both sides, A equals B, each equals the plain replay; B's supervisor
    reconnected and replication resynced. On the loop the net.aio.conns
    gauge rose by 2 or more and returns to its start after the close."""
    import torch

    from hypermerge_tpu_torch.net.faults import FaultPlan, FaultSwarm
    from hypermerge_tpu_torch.net.tcp import TcpSwarm
    from hypermerge_tpu_torch.repo import Repo

    cfg = CHURN
    aio = env.get("HM_NET_ASYNC") == "1"
    by_env = "HM_FAULT" in env
    with env_vars(**env):
        net0 = net_counters()
        t_run = time.perf_counter()
        ra, rb = Repo(memory=True), Repo(memory=True)
        sa, sb = TcpSwarm(), TcpSwarm()
        plan = None if by_env else FaultPlan(seed=cfg["seed"],
                                             events=cfg["events"])
        try:
            on_card(label, (ra, rb))
            if aio != (sa._async and sb._async):
                raise AssertionError(f"phase 3j {label}: the transport is "
                                     "not the one HM_NET_ASYNC asks for")
            ra.set_swarm(sa)
            rb.set_swarm(sb if by_env else FaultSwarm(sb, plan))
            fa, fb = ra.back.network.swarm, rb.back.network.swarm
            if by_env:
                if not (isinstance(fa, FaultSwarm)
                        and isinstance(fb, FaultSwarm)):
                    raise AssertionError(f"phase 3j {label}: HM_FAULT did "
                                         "not wrap both swarms")
                plan = fb.plan
            fb.connect(sa.address)
            conns_up = None
            if aio:
                # the gauge while the link is up: read once the two ends
                # are connected, not at a fixed point of the run, which
                # HM_FAULT's kill (200 ms into the run) can fall on
                start = net0.get("net.aio.conns", 0)
                wait_for(f"{label}: the loop's connections",
                         lambda: net_counters().get("net.aio.conns", 0)
                         >= start + 2, cfg["timeout_s"], phase="3j")
                conns_up = net_counters().get("net.aio.conns", 0)
            urls = [ra.create({"edits": []}) for _ in range(cfg["n_docs"])]
            handles = [rb.open(u) for u in urls]
            for h in handles:
                h.value(timeout=cfg["timeout_s"])
            for k in ck.launches:
                ck.launches[k] = 0
            t0 = time.perf_counter()
            n = cfg["n_edits"]
            quarter = max(1, n // 4)
            for i in range(n):
                for u in urls:
                    ra.change(u, lambda d, i=i: d["edits"].append(i))
                if i % 5 == 0:
                    for h in handles:
                        h.change(lambda d, i=i: d["edits"].append(1000 + i))
                if not by_env and i % quarter == quarter - 1:
                    fb.tick()  # the kill / heal schedule fires mid-burst
            if by_env:
                last = max(t for t, _ev in plan.events)
                wait_for("the spec's heal", lambda: plan.tick >= last,
                         cfg["timeout_s"], phase="3j")
            else:
                while plan.tick < len(cfg["events"]):
                    fb.tick()  # healed for the convergence wait
            want = n + (n + 4) // 5
            t_b = wait_for(f"{label}: B's convergence", lambda: all(
                len((h.value() or {}).get("edits", [])) >= want
                for h in handles), cfg["timeout_s"], phase="3j")
            wait_for(f"{label}: A's convergence", lambda: all(
                len(ra.doc(u)["edits"]) >= want for u in urls),
                cfg["timeout_s"], phase="3j")
            wall = time.perf_counter() - t0
            torch.cuda.synchronize()
            launches = {k: v for k, v in ck.launches.items() if v}
            bad = [u for u in urls if ra.doc(u) != rb.doc(u)
                   or len(rb.doc(u)["edits"]) != want]
            if bad:
                raise AssertionError(f"phase 3j {label}: {len(bad)} docs "
                                     "differ between A and B")
            check_replay(label, (ra, rb), urls)
            check_pinned(ra, rb, label, phase="3j")
            repl = {"a": ra.back.network.replication.stats,
                    "b": rb.back.network.replication.stats}
            churn = {
                "reconnects": fb.supervisor.stats["reconnects"],
                "resyncs": repl["a"]["resyncs"] + repl["b"]["resyncs"],
                "t_resync_ms": (repl["a"]["t_resync_ms"]
                                + repl["b"]["t_resync_ms"]),
                "frames_dropped_injected": fb.stats[
                    "frames_dropped_injected"],
                "plan_ticks": plan.tick,
            }
            stats = {"a": live_stats(ra), "b": live_stats(rb)}
        finally:
            ra.close()
            rb.close()
            sa.destroy()
            sb.destroy()
        net1 = net_counters()
        # the loop's busy time is read against this: set-up, the
        # handshakes, the opens and the burst, up to the close
        run_s = time.perf_counter() - t_run
        conns = None
        if aio:
            conns = {"start": net0.get("net.aio.conns", 0), "up": conns_up}
            conns["closed_s"] = wait_for(
                f"{label}: net.aio.conns back to its start",
                lambda: net_counters().get("net.aio.conns", 0)
                <= conns["start"], 30, phase="3j")
    if churn["reconnects"] < 1 or churn["resyncs"] < 1:
        raise AssertionError(f"phase 3j {label}: no reconnect or no resync "
                             f"after the kill: {churn}")
    if not launches.get("materialize_live"):
        raise AssertionError(f"phase 3j {label}: materialize_live never "
                             f"launched on the card: {launches}")
    net = {k: v - net0.get(k, 0) for k, v in net1.items()
           if k != "net.aio.conns"}
    if aio:
        if conns["up"] - conns["start"] < 2:
            raise AssertionError(f"phase 3j {label}: net.aio.conns {conns}")
        if not net.get("net.aio.loop_busy_ms", 0) > 0:
            raise AssertionError(f"phase 3j {label}: the loop never ran")
    return dict(
        label=label, env=env, docs=cfg["n_docs"], edits_a_doc=want,
        wall_s=wall, run_s=run_s, b_converged_s=t_b, launches=launches,
        churn=churn,
        live=stats, replication=repl, aio_conns=conns,
        loop_busy_ms=net.get("net.aio.loop_busy_ms"), net=net,
    )


def fleet_run(ck) -> dict:
    """Phase 3j (c): `_config_swarm`, cut to FLEET["n_peers"] card repos
    (its default: 16), each on a DhtSwarm bootstrapped off one DhtNode, no
    connect() anywhere; peers 1 to n // 5 wrapped in FaultSwarms (seed
    19 + i: kill, heal) ticked at
    one and two thirds of repo 0's 24 edits. The launch counts are set to
    0 just before the edits and read after every peer converged. Every
    peer reads {"edits": [0..23]}, bit-identical as sorted JSON and equal
    to the plain replay; a peer's replication frames stay within
    4 x fanout + 8 an edit."""
    import torch

    from hypermerge_tpu_torch import telemetry
    from hypermerge_tpu_torch.net.discovery import DhtNode, DhtSwarm
    from hypermerge_tpu_torch.net.faults import FaultPlan, FaultSwarm
    from hypermerge_tpu_torch.repo import Repo

    cfg = FLEET
    n, n_edits = cfg["n_peers"], cfg["n_edits"]
    with env_vars(**NET_KERNEL_ENV, **FLEET_ENV):
        boot = DhtNode()
        repos, swarms, faulted = [], [], []
        try:
            n_churn = max(1, n // 5)
            for i in range(n):
                repos.append(Repo(memory=True))
                sw = DhtSwarm(bootstrap=[boot.address])
                if 0 < i <= n_churn:  # never the creator
                    sw = FaultSwarm(sw, FaultPlan(
                        seed=cfg["seed"] + i,
                        events=[(1, "kill"), (2, "heal")]))
                    faulted.append(sw)
                swarms.append(sw)
                repos[-1].set_swarm(sw)
            on_card("(c)", repos)
            t0 = time.perf_counter()
            url = repos[0].create({"edits": []})
            handles = [r.open(url) for r in repos[1:]]
            for h in handles:
                h.value(timeout=cfg["join_timeout_s"])
            t_join = time.perf_counter() - t0
            frames0 = [r.back.network.replication.stats["frames_tx"]
                       for r in repos]
            snap0 = telemetry.snapshot()
            for k in ck.launches:
                ck.launches[k] = 0
            t0 = time.perf_counter()
            third = max(1, n_edits // 3)
            for i in range(n_edits):
                repos[0].change(url, lambda d, i=i: d["edits"].append(i))
                if i in (third, 2 * third):
                    for fs in faulted:
                        fs.tick()  # kill, then heal
            for fs in faulted:
                while fs.plan.tick < 2:
                    fs.tick()
            want = list(range(n_edits))
            wait_for("(c): every peer's convergence", lambda: all(
                (h.value() or {}).get("edits") == want for h in handles),
                cfg["timeout_s"], phase="3j")
            wall = time.perf_counter() - t0
            torch.cuda.synchronize()
            launches = {k: v for k, v in ck.launches.items() if v}
            blobs = {json.dumps(plain_value(r.doc(url)), sort_keys=True)
                     for r in repos}
            if blobs != {json.dumps({"edits": want}, sort_keys=True)}:
                raise AssertionError(f"phase 3j (c): {len(blobs)} distinct "
                                     "values across the fleet")
            check_replay("(c)", repos, [url])
            amp = [(r.back.network.replication.stats["frames_tx"] - f0)
                   / n_edits for r, f0 in zip(repos, frames0)]
            snap1 = telemetry.snapshot()

            def delta(k):
                return snap1.get(k, 0) - snap0.get(k, 0)

            numbers = dict(
                peers=n, churned=len(faulted), fanout=cfg["fanout"],
                edits=n_edits, t_join_s=t_join, wall_s=wall,
                frame_amp_max=max(amp), frame_amp_mean=sum(amp) / len(amp),
                lookups=delta("dht.lookups"),
                lookup_hops_mean=delta("dht.lookup_hops")
                / max(delta("dht.lookups"), 1),
                reconnects=sum(sw.supervisor.stats["reconnects"]
                               for sw in swarms),
                resyncs=sum(r.back.network.replication.stats["resyncs"]
                            for r in repos),
                launches=launches,
                device_dispatches=sum(r.back.live.stats["device_dispatches"]
                                      for r in repos),
            )
        finally:
            for r in repos:
                r.close()
            for sw in swarms:
                sw.destroy()
            boot.close()
    if numbers["frame_amp_max"] > 4 * cfg["fanout"] + 8:
        raise AssertionError(f"phase 3j (c): frames a peer an edit above "
                             f"4 x fanout + 8: {numbers}")
    return numbers


def chaos_path(ck) -> tuple:
    """Phase 3j: (a) the churn run on the thread stack and on the loop,
    (b) the same under HM_FAULT, (c) the DHT fleet. Returns (the launch
    counts of the four runs summed, the numbers)."""
    card = card_line()
    base = dict(NET_KERNEL_ENV, **CHURN_ENV)
    runs = [churn_run(ck, "(a) threads", dict(base, HM_NET_ASYNC="0")),
            churn_run(ck, "(a) loop", dict(base, HM_NET_ASYNC="1")),
            churn_run(ck, "(b) HM_FAULT", dict(base, HM_NET_ASYNC="1",
                                               HM_FAULT=HM_FAULT_SPEC))]
    for r in runs:
        log(f"phase 3j {r['label']}: " + json.dumps(r) + f" [{card}]")
    fleet = fleet_run(ck)
    log("phase 3j (c) DHT fleet: " + json.dumps(fleet) + f" [{card}]")
    counts = {}
    for launches in [r["launches"] for r in runs] + [fleet["launches"]]:
        for k, v in launches.items():
            counts[k] = counts.get(k, 0) + v
    log("phase 3j check: " + "; ".join(
        f"{r['label']} converged in {r['wall_s']:.3f} s (reconnects "
        f"{r['churn']['reconnects']}, resyncs {r['churn']['resyncs']}, "
        f"materialize_live {r['launches'].get('materialize_live')}"
        + (f", loop busy {r['loop_busy_ms']:.1f} ms of the run's "
           f"{r['run_s'] * 1e3:.1f}" if r["aio_conns"] else "") + ")"
        for r in runs)
        + f"; (c) {fleet['peers']} peers joined in {fleet['t_join_s']:.3f} s "
        f"and converged in {fleet['wall_s']:.3f} s, frame amp max "
        f"{fleet['frame_amp_max']:.2f}, launches {fleet['launches']}; every "
        "value equal on all sides and to the plain replay")
    return counts, dict(card=card, crypto=transport_crypto(), churn=runs,
                        fleet=fleet)


# the hub slice (phase 3k): bench.py's many-writer plane on the sharded hub
# (`_config_writers` at its 8-writer point, `_config_writers_hotdoc`, and
# tests/test_wal.py's worker kill), every process a port process: the daemon
# `python -m hypermerge_tpu_torch.net.ipc <repo> <sock> --hub` (the card by
# default), HM_WORKERS=2 worker daemons it spawns, and writer processes on
# `connect_frontend`, in `_writer_daemon_env`'s environment (durable acks
# over the group-commit journal). Local edits resolve in the live engine's
# `apply_local` and never enter its tick, so the workers' kernels are those
# of a reopened shard: the daemon is restarted over the writers' repo and
# every doc read through one `open_many`, which each worker opens on the
# card (pack_prefix, the slab's one launch); (b) runs on that daemon; then
# each shard is opened in this process
HUB = dict(writers=8, edits=200, paste=16, hot_writers=8, hot_edits=60,
           kill_edits=8, timeout_s=180)
HUB_ENV = dict(HM_FSYNC="1", HM_ACK_DURABLE="1", HM_WAL_MS="30",
               HM_WORKERS="2")
# the restarted daemon serves (a)'s `open_many`, the hot doc's herd and the
# kill, at tests/test_wal.py's interactive latency (bench.py's daemon env
# yields HM_WAL_MS to the caller's)
KILL_ENV = dict(HUB_ENV, HM_WAL_MS="3", HM_WORKER_RESPAWN_MS="100")
HUB_MODULE = "hypermerge_tpu_torch.net.ipc"
HUB_COUNTERS = ("storage.wal.appends", "storage.wal.fsyncs",
                "live.local_changes", "live.device_dispatches",
                "live.kernel_runs", "live.ticks", "live.adopted",
                "pipeline.slabs", "slab.h2d_bytes")
# bench.py `_WRITER_CHILD` on the port: one doc, `edits` ack-paced edits
# (the frontend keeps one request in flight; the durable echo, whose
# history index the handle reports, releases the next), then the paste: one
# change setting `paste` keys
HUB_WRITER = r"""
import json, sys, threading, time

sock, w, n_edits, paste = sys.argv[1], *map(int, sys.argv[2:5])
from hypermerge_tpu_torch.net.ipc import connect_frontend

front, close = connect_frontend(sock)
url = front.create({"w": w, "n": -1})
h = front.open(url)
h.value(timeout=120)
latest, goal, done = [0], [None], threading.Event()

def on_state(_state, index):
    latest[0] = max(latest[0], index)
    if goal[0] is not None and latest[0] >= goal[0]:
        done.set()

h.subscribe(on_state)
print(json.dumps({"url": url}), flush=True)
sys.stdin.readline()  # the coordinator's "go"
base = latest[0]
goal[0] = base + n_edits
t0 = time.perf_counter()
for i in range(n_edits):
    front.change(url, lambda d, _i=i: d.__setitem__("n", _i))
ok = done.wait(timeout=120)
secs = time.perf_counter() - t0
goal[0] = base + n_edits + 1
done.clear()

def paste_fn(d):
    for k in range(paste):
        d["p%d" % k] = 100 * w + k

front.change(url, paste_fn)
ok = done.wait(timeout=120) and ok
print(json.dumps({"url": url, "secs": secs, "acked": ok}), flush=True)
close()
"""
# bench.py `_HOTDOC_CHILD` on the port: ack-paced edits of its own keys in
# one shared doc, then the convergence barrier and a canonical JSON digest
HUB_HOT_WRITER = r"""
import hashlib, json, sys, time

sock, url = sys.argv[1], sys.argv[2]
idx, n_edits, n_writers = map(int, sys.argv[3:6])
from hypermerge_tpu_torch.net.ipc import connect_frontend

front, close = connect_frontend(sock)
h = front.open(url)

def val():
    try:
        return h.value(timeout=0.2)
    except TimeoutError:
        return None

deadline = time.time() + 120
while time.time() < deadline:
    v = val()
    if v is not None and "edits" in v:
        break
    time.sleep(0.02)
else:
    raise SystemExit("shared doc never materialized")
print("ready", flush=True)
sys.stdin.readline()  # the coordinator's "go"
t0 = time.perf_counter()
for i in range(n_edits):
    key = "%d.%d" % (idx, i)
    front.change(url, lambda d, _k=key, _i=i: d["edits"].__setitem__(_k, _i))
    deadline = time.time() + 120
    while time.time() < deadline:
        v = val()
        if v is not None and key in v["edits"]:
            break
        time.sleep(0.001)
secs = time.perf_counter() - t0
want = n_writers * n_edits
deadline = time.time() + 180
v = None
while time.time() < deadline:
    v = val()
    if v is not None and len(v.get("edits", {})) >= want:
        break
    time.sleep(0.02)
blob = json.dumps(v, sort_keys=True, separators=(",", ":"))
print(json.dumps({
    "secs": secs,
    "acked": v is not None and len(v.get("edits", {})) >= want,
    "digest": hashlib.sha256(blob.encode("utf-8")).hexdigest(),
}), flush=True)
close()
"""


def hub_child_env(env: dict) -> dict:
    here = os.path.dirname(os.path.abspath(__file__))
    return dict(os.environ, PYTHONPATH=here, **env)


def start_hub(root: str, repo: str, env: dict, device=None) -> dict:
    """The daemon in a process group of its own (a hub and the workers it
    spawns), its standard error in a file, its output lines gathered by a
    thread; returns once it printed "backend ready" and both workers'
    "worker <i> pid <pid>" lines."""
    import threading

    sock = os.path.join(root, f"hub{len(os.listdir(root))}.sock")
    err_path = sock + ".err"
    args = [sys.executable, "-m", HUB_MODULE, repo, sock, "--hub"]
    if device is not None:
        args += ["--device", device]
    with open(err_path, "w") as err:
        proc = subprocess.Popen(
            args, stdout=subprocess.PIPE, stderr=err, text=True,
            env=hub_child_env(env), start_new_session=True,
            cwd=os.path.dirname(os.path.abspath(__file__)),
        )
    lines: list = []
    threading.Thread(target=lambda: lines.extend(iter(proc.stdout.readline,
                                                      "")),
                     daemon=True).start()
    hub = dict(proc=proc, sock=sock, err=err_path, lines=lines)
    n = int(env["HM_WORKERS"])
    t0 = time.perf_counter()
    while len(worker_pids(hub)) < n:
        if proc.poll() is not None or time.perf_counter() - t0 > 240:
            raise AssertionError(f"phase 3k: the hub did not come up: "
                                 f"{lines} {hub_err(hub)}")
        time.sleep(0.02)
    hub["t_up_s"] = time.perf_counter() - t0
    hub["pids"] = worker_pids(hub)
    return hub


def worker_pids(hub: dict) -> dict:
    """The workers' pids by shard, the latest spawn of each."""
    pids = {}
    for line in list(hub["lines"]):
        parts = line.split()
        if parts[:1] == ["worker"] and parts[2:3] == ["pid"]:
            pids[int(parts[1])] = int(parts[3])
    return pids


def hub_err(hub: dict) -> str:
    with open(hub["err"]) as f:
        return f.read()[-2000:]


def pid_alive(pid: int) -> bool:
    """Whether a process is still running (a zombie counts as gone)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rpartition(")")[2].split()[0] != "Z"
    except FileNotFoundError:
        return False


def stop_hub(hub: dict) -> None:
    """SIGTERM to the hub, as bench.py stops its daemon; each worker sees
    its hub connection close and closes its repo. Waits for every worker
    pid to end; whatever is left of the group is then killed."""
    import signal

    proc = hub["proc"]
    try:
        if proc.poll() is None:
            proc.terminate()
            proc.wait(timeout=30)
        t0 = time.perf_counter()
        while any(pid_alive(p) for p in hub["pids"].values()):
            if time.perf_counter() - t0 > 60:
                raise AssertionError("phase 3k: a worker did not close after "
                                     "its hub stopped")
            time.sleep(0.02)
    finally:
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        if proc.poll() is None:
            proc.wait(timeout=30)


def worker_proof(hub: dict, device, kernels=()) -> dict:
    """Reads of each worker's /proc/<pid>/cmdline and maps: the port's
    module with the device on its command line; on the card, libcuda and
    the built library of each of `kernels` mapped. Returns what was read."""
    from hypermerge_tpu_torch.kernels import _build

    want_dev = device or "cuda"
    out = {}
    for i, pid in hub["pids"].items():
        with open(f"/proc/{pid}/cmdline", "rb") as f:
            argv = f.read().decode().split("\0")
        with open(f"/proc/{pid}/maps") as f:
            maps = f.read()
        if HUB_MODULE not in argv or "--device" not in argv or argv[
                argv.index("--device") + 1] != want_dev:
            raise AssertionError(f"phase 3k: worker {i} is not the port's "
                                 f"module on {want_dev}: {argv}")
        libs = [str(_build.target(k)) for k in kernels] if device is None \
            else []
        mapped = {"libcuda": "libcuda" in maps,
                  **{os.path.basename(p): p in maps for p in libs}}
        if device is None and not all(mapped.values()):
            raise AssertionError(f"phase 3k: worker {i} maps {mapped}")
        out[i] = dict(pid=pid, argv=argv[1:], mapped=mapped)
    return out


def hub_wait(what: str, fn, timeout_s: float = HUB["timeout_s"]) -> float:
    return wait_for(what, fn, timeout_s, phase="3k")


def handle_value(h):
    try:
        return h.value(timeout=0.2)
    except TimeoutError:
        return None


def hub_telemetry(front) -> dict:
    """The hub's merged Telemetry reply: the workers block and the summed
    counters phase 3k reads."""
    got = []
    front.telemetry(got.append)
    hub_wait("the telemetry reply", lambda: got, 30)
    p = got[0]
    c = p["counters"]
    return dict(workers=p["workers"],
                counters={k: c.get(k, 0) for k in HUB_COUNTERS},
                per_worker={k: v for k, v in c.items()
                            if k.startswith("workers.")})


def writers_run(root: str, device=None) -> dict:
    """Phase 3k (a), the writers: HUB["writers"] processes, each on its own
    doc, HUB["edits"] ack-paced edits and the paste; then a fresh observer
    reads every doc, and the merged telemetry. Returns the numbers, the
    repo and every doc's value."""
    from hypermerge_tpu_torch.net.ipc import connect_frontend

    cfg = HUB
    repo = os.path.join(root, "writers")
    hub = start_hub(root, repo, HUB_ENV, device)
    writers = []
    try:
        proof = worker_proof(hub, device)
        writers = [subprocess.Popen(
            [sys.executable, "-c", HUB_WRITER, hub["sock"], str(w),
             str(cfg["edits"]), str(cfg["paste"])],
            env=hub_child_env(HUB_ENV), stdin=subprocess.PIPE,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            cwd=os.path.dirname(os.path.abspath(__file__)))
            for w in range(cfg["writers"])]
        urls = []
        for w in writers:
            line = w.stdout.readline()
            if not line:
                raise AssertionError(f"phase 3k (a): a writer failed: "
                                     f"{w.stderr.read()[-1000:]}")
            urls.append(json.loads(line)["url"])
        for w in writers:  # every doc open: release the herd
            w.stdin.write("go\n")
            w.stdin.flush()
        outs = [json.loads(w.stdout.readline() or "{}") for w in writers]
        if not all(o.get("acked") for o in outs):
            raise AssertionError(f"phase 3k (a): writers not acked: {outs}")
        want = {u: dict({"w": w, "n": cfg["edits"] - 1},
                        **{f"p{k}": 100 * w + k for k in range(cfg["paste"])})
                for w, u in enumerate(urls)}
        # a fresh observer connection reads every doc
        front, close = connect_frontend(hub["sock"])
        try:
            t0 = time.perf_counter()
            handles = {u: front.open(u) for u in urls}
            hub_wait("the observer's reads", lambda: all(
                handle_value(h) == want[u] for u, h in handles.items()))
            t_observe = time.perf_counter() - t0
            tele = hub_telemetry(front)
        finally:
            close()
        hub["pids"] = worker_pids(hub)
    finally:
        for w in writers:
            if w.poll() is None:
                w.kill()
            w.wait(timeout=30)
        stop_hub(hub)
    wall = max(o["secs"] for o in outs)
    shards = {}
    from hypermerge_tpu_torch.net.ipc import _shard_of
    for u in urls:
        shards.setdefault(_shard_of(u[len("hypermerge:/"):], 2), []).append(u)
    return dict(
        repo=repo, want=want, shards=shards,
        numbers=dict(
            writers=cfg["writers"], edits=cfg["edits"], paste=cfg["paste"],
            t_hub_up_s=hub["t_up_s"], writer_secs=[o["secs"] for o in outs],
            durable_edits_per_s=cfg["writers"] * cfg["edits"] / wall,
            t_observe_s=t_observe, telemetry=tele, workers=proof,
            docs_a_shard={k: len(v) for k, v in shards.items()}),
    )


def reopen_run(hub: dict, run: dict, device=None) -> dict:
    """Phase 3k (a), the reopen through the hub: on the daemon restarted
    over the writers' repo, a reader's one `open_many` of every doc, which
    each worker opens as a bulk load (on the card: pack_prefix and the
    slab's one launch of doc_kernel.cu, whose libraries the workers' maps
    must then show); every value equal to the observer's."""
    from hypermerge_tpu_torch.net.ipc import connect_frontend

    want = run["want"]
    front, close = connect_frontend(hub["sock"])
    try:
        t0 = time.perf_counter()
        handles = dict(zip(want, front.open_many(list(want))))
        hub_wait("the reopened reads", lambda: all(
            handle_value(h) == want[u] for u, h in handles.items()))
        t_read = time.perf_counter() - t0
        tele = hub_telemetry(front)
    finally:
        close()
    proof = worker_proof(hub, device, kernels=("pack_prefix", "doc_kernel"))
    return dict(t_hub_up_s=hub["t_up_s"], t_open_many_read_s=t_read,
                telemetry=tele, workers=proof)


def reopen_shards(ck, run: dict, device=None) -> tuple:
    """Phase 3k (a), each shard repo opened in this process with the port's
    `Repo(path)`: `open_many` + `fetch_bulk_summaries` with the launch
    counts set to 0 just before and read just after; every doc's value
    equal to the observer's. Returns (launches, the numbers)."""
    from hypermerge_tpu_torch.repo import Repo

    for k in ck.launches:
        ck.launches[k] = 0
    stats = {}
    t0 = time.perf_counter()
    for i, urls in sorted(run["shards"].items()):
        repo = Repo(path=os.path.join(run["repo"], f"shard-{i}"),
                    device=device)
        try:
            repo.open_many(urls)
            repo.back.fetch_bulk_summaries()
            got = {u: plain_value(repo.doc(u)) for u in urls}
            stats[i] = {k: repo.back.last_bulk_stats.get(k)
                        for k in ("docs", "fast", "pipeline")}
        finally:
            repo.close()
        bad = [u for u in urls if got[u] != run["want"][u]]
        if bad:
            raise AssertionError(f"phase 3k (a): shard {i} reopened "
                                 f"{len(bad)} docs unlike the observer")
    launches = {k: v for k, v in ck.launches.items() if v}
    return launches, dict(t_reopen_s=time.perf_counter() - t0, stats=stats)


def hotdoc_kill_run(hub: dict, device=None) -> dict:
    """Phase 3k (b): bench.py `_config_writers_hotdoc` (HUB["hot_writers"]
    processes x HUB["hot_edits"] ack-paced edits on one shared doc, every
    writer's canonical JSON digest bit-identical), then on the same daemon
    tests/test_wal.py's `test_worker_sigkill_midburst_acked_lost_zero`:
    HUB["kill_edits"] edits each acked by an observer's durable patch, the
    doc's worker killed with SIGKILL, one more edit, the hub's respawn, and
    a brand-new connection that reads every acked edit and writes."""
    import signal

    from hypermerge_tpu_torch.net.ipc import _shard_of, connect_frontend

    cfg = HUB
    writers, closers = [], []
    try:
        front, close = connect_frontend(hub["sock"])
        closers.append(close)
        url = front.create({"edits": {}})
        got = []
        front.materialize(url, 1, got.append)
        hub_wait("the shared doc", lambda: got, 60)
        writers = [subprocess.Popen(
            [sys.executable, "-c", HUB_HOT_WRITER, hub["sock"], url, str(i),
             str(cfg["hot_edits"]), str(cfg["hot_writers"])],
            env=hub_child_env(KILL_ENV), stdin=subprocess.PIPE,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            cwd=os.path.dirname(os.path.abspath(__file__)))
            for i in range(cfg["hot_writers"])]
        for w in writers:
            if w.stdout.readline().strip() != "ready":
                raise AssertionError(f"phase 3k (b): a hot writer failed: "
                                     f"{w.stderr.read()[-1000:]}")
        for w in writers:
            w.stdin.write("go\n")
            w.stdin.flush()
        outs = [json.loads(w.stdout.readline() or "{}") for w in writers]
        digests = {o.get("digest") for o in outs}
        if not all(o.get("acked") for o in outs) or len(digests) != 1:
            raise AssertionError(f"phase 3k (b): the hot doc diverged: "
                                 f"{outs}")
        hot_wall = max(o["secs"] for o in outs)
        # the kill: an observer's value moves only on the durable patch
        h = front.open(url)
        obs, close_obs = connect_frontend(hub["sock"])
        closers.append(close_obs)
        hobs = obs.open(url)
        n_hot = cfg["hot_writers"] * cfg["hot_edits"]
        hub_wait("the observer", lambda: len(
            (handle_value(hobs) or {}).get("edits", {})) >= n_hot, 60)
        hub_wait("the writer's view", lambda: len(
            (handle_value(h) or {}).get("edits", {})) >= n_hot, 60)

        def acked_by_observer(key, timeout_s=10.0):
            try:
                hub_wait(f"the ack of {key}", lambda: (handle_value(hobs)
                         or {}).get("edits", {}).get(key) == 1, timeout_s)
                return True
            except AssertionError:
                return False

        acked = [f"{i}.{j}" for i in range(cfg["hot_writers"])
                 for j in range(cfg["hot_edits"])]
        for i in range(cfg["kill_edits"]):
            front.change(url, lambda d, k=f"k{i}": d["edits"].__setitem__(
                k, 1))
            if not acked_by_observer(f"k{i}"):
                raise AssertionError(f"phase 3k (b): edit k{i} never acked")
            acked.append(f"k{i}")
        owner = _shard_of(url[len("hypermerge:/"):], 2)
        victim = hub["pids"][owner]
        t_kill = time.perf_counter()
        os.kill(victim, signal.SIGKILL)  # mid-burst: kill -9
        front.change(url, lambda d: d["edits"].__setitem__("post-kill", 1))
        post_kill = acked_by_observer("post-kill", 5.0)
        if post_kill:
            acked.append("post-kill")
        hub_wait("the respawn", lambda: any("respawned" in ln
                                            for ln in hub["lines"]), 120)
        t_respawn = time.perf_counter() - t_kill
        f2, close2 = connect_frontend(hub["sock"])
        closers.append(close2)
        h2 = f2.open(url)

        def lost():
            edits = (handle_value(h2) or {}).get("edits", {})
            return [k for k in acked if k not in edits]

        hub_wait("the recovered read", lambda: not lost(), 60)
        t_first_read = time.perf_counter() - t_kill
        acked_lost = len(lost())
        f2.change(url, lambda d: d["edits"].__setitem__("fresh", 1))
        hub_wait("the new writer's edit", lambda: (handle_value(h2) or {})
                 .get("edits", {}).get("fresh") == 1, 60)
        hub["pids"] = worker_pids(hub)
        respawned = worker_proof(hub, device)
        tele = hub_telemetry(f2)
        if tele["workers"][str(owner)]["respawns"] != 1:
            raise AssertionError(f"phase 3k (b): respawns {tele['workers']}")
    finally:
        for close in closers:
            close()
        for w in writers:
            if w.poll() is None:
                w.kill()
            w.wait(timeout=30)
    return dict(
        hot_writers=cfg["hot_writers"], hot_edits=cfg["hot_edits"],
        hot_edits_per_s=n_hot / hot_wall,
        digest=digests.pop(), killed_worker=owner, killed_pid=victim,
        respawned_pid=hub["pids"][owner], post_kill_acked=post_kill,
        acked=len(acked), acked_lost=acked_lost, t_respawn_s=t_respawn,
        t_first_read_s=t_first_read, telemetry=tele,
        respawned_workers=respawned)


def hub_path(ck) -> tuple:
    """Phase 3k on the card: (a) the writers, the observer and the merged
    telemetry; the daemon restarted, its `open_many`; (b) on it, the hot
    doc and the worker kill; then each shard reopened in this process
    (pack_prefix and materialize_wire must launch). Returns (the reopen's
    launch counts, the numbers)."""
    card = card_line()
    with tempfile.TemporaryDirectory(prefix="hm-hub-") as root:
        t0 = time.perf_counter()
        run = writers_run(root)
        log("phase 3k (a) writers: " + json.dumps(run["numbers"])
            + f" [{card}]")
        # one restarted daemon serves (a)'s reads and then (b), at the
        # kill's interactive latency
        hub = start_hub(root, run["repo"], KILL_ENV)
        try:
            through_hub = reopen_run(hub, run)
            log("phase 3k (a) restarted hub, open_many: "
                + json.dumps(through_hub) + f" [{card}]")
            hot = hotdoc_kill_run(hub)
            log("phase 3k (b) hot doc + kill: " + json.dumps(hot)
                + f" [{card}]")
        finally:
            stop_hub(hub)
        launches, reopen = reopen_shards(ck, run)
        log(f"phase 3k (a) shards reopened here: {json.dumps(reopen)}, "
            f"launches {launches} [{card}]")
        for k in BULK:
            if not launches.get(k):
                raise AssertionError(f"phase 3k (a): {k} never launched in "
                                     f"the shards' reopen: {launches}")
        wall = time.perf_counter() - t0
    tele = run["numbers"]["telemetry"]
    log(f"phase 3k check: {HUB['writers']} durable-ack writers through 2 "
        f"card workers at {run['numbers']['durable_edits_per_s']:.1f} "
        f"edits/s, every doc == its writer's sequence at the observer, "
        f"through the restarted hub's open_many and in this process's "
        f"reopen ({launches}); workers.*.edits "
        f"{[w['edits'] for w in tele['workers'].values()]}, wal appends "
        f"{tele['counters']['storage.wal.appends']}, live device_dispatches "
        f"{tele['counters']['live.device_dispatches']}; hot doc "
        f"{HUB['hot_writers']} x {HUB['hot_edits']} bit-identical, the "
        f"killed worker respawned in {hot['t_respawn_s']:.3f} s, first read "
        f"at {hot['t_first_read_s']:.3f} s, acked_lost {hot['acked_lost']}; "
        f"phase wall {wall:.1f} s [{card}]")
    return launches, dict(card=card, writers=run["numbers"],
                          reopen_through_hub=through_hub,
                          reopen_here=reopen, hotdoc_kill=hot)


# the service slice (phase 3l): the service plane (serve/overload.py) on the
# card. (a) in this process, a `Repo(path)` on a copy of phase 3d's corpus
# under durable acks, read `{kind: len}` with the ladder pinned healthy,
# brownout and shed (HM_SERVICE_FORCE; the controller rebuilt for each part
# as the backend builds it), then driven by its own signals at a 1 ms SLO;
# (b) bench.py `_config_service` at its defaults, every process a port
# process: the hub daemon with the serve tier, the service plane, durable
# group-commit acks and DHT membership on the card (HM_WORKERS=0: phase 3k
# holds the sharded workers), 4 frontend processes running bench.py's
# `_SERVICE_CHILD` on `connect_frontend`, and a card `Repo` replicating
# through the DHT in this process
SERVICE = dict(hot=32, cold=64, hot_rounds=4, readers=8, writes=16,
               quota_reads_s=64, quota_burst=16, tenants=2,
               threads_a_tenant=2, shed_s=1.0, slo_ms=1, tick_ms=25,
               down_ticks=10, climb_max_s=5.0, hold_after_shed_s=0.25,
               healthy_max_s=5.0)
SERVICE_ENV = dict(HM_SERVICE="1", HM_FSYNC="1", HM_ACK_DURABLE="1")
# bench.py `_config_service`'s defaults and daemon environment
STORM = dict(clients=4, docs=48, ramp_s=1.0, hold_s=3.0, slo_ms=25.0,
             gate_s=10.0, max_threads=16,
             bounds=[0.0005, 0.001, 0.002, 0.005, 0.01, 0.02, 0.05, 0.1,
                     0.25, 0.5, 1.0, 2.5])
STORM_ENV = dict(HM_FSYNC="1", HM_ACK_DURABLE="1", HM_WAL_MS="30",
                 HM_WORKERS="0", HM_SERVICE="1", HM_SERVICE_P99_SLO_MS="25.0",
                 HM_SERVICE_TICK_MS="25", HM_QUOTA_READS_S="64",
                 HM_QUOTA_BURST="16", HM_DHT_ANNOUNCE_S="0.5",
                 HM_DHT_LOOKUP_S="0.5")
# bench.py `_SERVICE_CHILD` on the port: one IPC connection (one tenant),
# zipf-ish reads of `{kind: len}` with every 64th an open, and an ack-paced
# durable writer on its own doc; one phase a command on standard input
SERVICE_CHILD = r"""
import bisect, json, random, sys, threading, time

sock, idx = sys.argv[1], int(sys.argv[2])

from hypermerge_tpu_torch.net.ipc import connect_frontend
from hypermerge_tpu_torch.serve.overload import Overload

front, close = connect_frontend(sock)
setup = json.loads(sys.stdin.readline())
read_urls = setup["read_urls"]
own_url = setup["write_urls"][idx]
BOUNDS = setup["bounds"]
query = {"kind": "len", "path": []}

w = [1.0 / (k + 1) ** 1.2 for k in range(len(read_urls))]
cum, s = [], 0.0
for x in w:
    s += x
    cum.append(s)

h = front.open(own_url)

def val(timeout=0.05):
    try:
        return h.value(timeout=timeout)
    except TimeoutError:
        return None

deadline = time.time() + 60
while time.time() < deadline:
    if val() is not None:
        break
    time.sleep(0.02)
else:
    raise SystemExit("write doc never materialized")

wseq = [0]
wacked = [0]

def hist_new():
    return [0] * (len(BOUNDS) + 1)

def hist_add(hist, dt):
    hist[bisect.bisect_left(BOUNDS, dt)] += 1

print("ready", flush=True)

for line in sys.stdin:
    cmd = json.loads(line)
    if cmd.get("op") == "quit":
        break
    threads, secs = int(cmd["threads"]), float(cmd["secs"])
    do_write = bool(cmd.get("writes"))
    stop = time.time() + secs
    out = {
        "reads": 0, "shed": 0, "errors": 0, "opens": 0,
        "rhist": hist_new(), "whist": hist_new(),
        "writes": 0, "write_timeouts": 0,
    }
    lock = threading.Lock()

    def reader(seed):
        rng = random.Random((idx << 10) ^ seed)
        n = shed = errs = opens = 0
        hist = hist_new()
        k = 0
        while time.time() < stop:
            u = read_urls[bisect.bisect_left(cum, rng.random() * s)]
            k += 1
            t0 = time.perf_counter()
            try:
                if k % 64 == 0:
                    if front.open(u).value(timeout=60.0) is None:
                        errs += 1
                    else:
                        opens += 1
                    continue
                v = front.read(u, query, timeout=60.0)
                if v is None:
                    errs += 1
                else:
                    n += 1
                    hist_add(hist, time.perf_counter() - t0)
            except Overload as e:
                shed += 1
                time.sleep(min(max(e.retry_after_s, 1e-3), 0.05))
            except Exception:
                errs += 1
        with lock:
            out["reads"] += n
            out["shed"] += shed
            out["errors"] += errs
            out["opens"] += opens
            for i, c in enumerate(hist):
                out["rhist"][i] += c

    def writer():
        n = tmo = 0
        hist = hist_new()
        while time.time() < stop:
            seq = wseq[0]
            key = "c%d.%d" % (idx, seq)
            t0 = time.perf_counter()
            front.change(
                own_url,
                lambda d, _k=key, _s=seq: d["edits"].__setitem__(_k, _s),
            )
            wseq[0] += 1
            lim = time.time() + 30
            acked = False
            while time.time() < lim:
                v = val(timeout=0.02)
                if v is not None and key in v.get("edits", {}):
                    acked = True
                    break
                time.sleep(0.002)
            if acked:
                n += 1
                hist_add(hist, time.perf_counter() - t0)
                if seq == wacked[0]:
                    wacked[0] = seq + 1
            else:
                tmo += 1
                break
        with lock:
            out["writes"] += n
            out["write_timeouts"] += tmo
            for i, c in enumerate(hist):
                out["whist"][i] += c

    t0 = time.perf_counter()
    ts = [threading.Thread(target=reader, args=(k,)) for k in range(threads)]
    if do_write:
        ts.append(threading.Thread(target=writer))
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    out["secs"] = time.perf_counter() - t0
    out["acked"] = wacked[0]
    print(json.dumps(out), flush=True)

close()
"""


def service_controller(back, trace=None, **env):
    """The backend's service plane rebuilt under `env`: the running
    controller closed, then `RepoBackend._start_service` (a new controller
    on the backend's own signals, its p99 window, the journal's ack pacer,
    started). With `trace`, each of its ticks from then on appends (time,
    state, signals); a tick before the wrap precedes every read."""
    back.overload.close()
    with env_vars(**env):
        back._start_service()
    ctl = back.overload
    if trace is not None:
        tick = ctl.tick

        def traced(sig=None):
            state = tick(sig)
            trace.append((time.perf_counter(), state, ctl.report()["signals"]))
            return state

        ctl.tick = traced
    return ctl


def serve_delta(before, after) -> dict:
    return {k: int(after.get("serve." + k, 0) - before.get("serve." + k, 0))
            for k in ("dispatches", "installs", "fallbacks", "reads")}


def service_reads(ck, repo, urls, threads=1, tenant=None):
    """`{kind: len}` reads of `urls` on `threads` threads; returns (answers
    by url, launches of the serve kernels, serve.* deltas)."""
    from hypermerge_tpu_torch import telemetry

    query = {"kind": "len", "path": []}
    if tenant is not None:
        query["tenant"] = tenant
    got = [None] * len(urls)

    def reader(n):
        for i in range(n, len(urls), threads):
            got[i] = repo.read(urls[i], dict(query))

    before = {k: ck.launches[k] for k in SERVE}
    snap0 = telemetry.snapshot()
    run_threads(threads, reader)
    snap1 = telemetry.snapshot()
    launches = {k: ck.launches[k] - before[k] for k in SERVE}
    answers = {}
    for u, a in zip(urls, got):
        if a is None or answers.setdefault(u, a) != a:
            raise AssertionError(f"phase 3l: read of {u} answered {a}")
    return answers, launches, serve_delta(snap0, snap1)


def durable_acks(repo, url, tag, n) -> list:
    """`n` ack-paced durable edits of `url`: each one's seconds from the
    change until the repo's handle shows it (the durable echo)."""
    h = repo.open(url)
    out = []
    for i in range(n):
        key = f"{tag}{i}"
        t0 = time.perf_counter()
        repo.change(url, lambda d, k=key: d["edits"].__setitem__(k, 1))
        while True:
            try:
                v = h.value(timeout=0.05)
            except TimeoutError:
                v = None
            if v is not None and key in v["edits"]:
                break
            if time.perf_counter() - t0 > 30:
                raise AssertionError(f"phase 3l: edit {key} never acked")
            time.sleep(0.0002)
        out.append(time.perf_counter() - t0)
    return out


def check_serve(label, launches, delta):
    if launches["serve_counts"] == 0:
        raise AssertionError(f"phase 3l {label}: serve_counts never launched")
    if sum(launches.values()) != delta["dispatches"]:
        raise AssertionError(f"phase 3l {label}: launches {launches} != "
                             f"serve.dispatches {delta['dispatches']}")


def service_inproc(ck, corpus, urls, device=None) -> tuple:
    """Phase 3l (a) on the card (or `device`); returns (the launches of the
    open and the reads, the numbers)."""
    import threading

    from hypermerge_tpu_torch import telemetry
    from hypermerge_tpu_torch.repo import Repo
    from hypermerge_tpu_torch.serve.overload import (
        BROWNOUT, HEALTHY, SHED, STATE_NAMES, Overload)
    from hypermerge_tpu_torch.serve.tier import host_read
    from hypermerge_tpu_torch.utils.ids import validate_doc_url

    cfg = SERVICE
    hot = urls[:cfg["hot"]]
    cold_a = urls[cfg["hot"]:cfg["hot"] + cfg["cold"]]
    cold_b = urls[cfg["hot"] + cfg["cold"]:cfg["hot"] + 2 * cfg["cold"]]
    hot_mix = hot * cfg["hot_rounds"]
    numbers = {}
    with env_vars(HM_SERVICE_FORCE="healthy", **SERVICE_ENV):
        for k in ck.launches:
            ck.launches[k] = 0
        repo = Repo(path=corpus, device=device)
        try:
            back = repo.back
            if back.overload is None or back.overload.state() != HEALTHY:
                raise AssertionError("phase 3l: the repo has no controller")
            t0 = time.perf_counter()
            repo.open_many(urls)
            back.fetch_bulk_summaries()
            open_launches = {k: ck.launches[k] for k in BULK}
            if not all(open_launches.values()):
                raise AssertionError(f"phase 3l (a): the open launched "
                                     f"{open_launches}")
            numbers["open_s"] = time.perf_counter() - t0
            want = {}
            for u in urls[:cfg["hot"] + 2 * cfg["cold"]]:
                doc = back.docs[validate_doc_url(u)]
                want[u] = host_read(doc, {"kind": "len", "path": []})["value"]
            wurl = repo.create({"edits": {}})

            # (i) healthy: the hot set installs and serves, cold reads install
            ctl = back.overload
            base, l_hot, d_hot = service_reads(ck, repo, hot)
            ans, l_mix, d_mix = service_reads(ck, repo, hot_mix,
                                              cfg["readers"])
            cold, l_cold, d_cold = service_reads(ck, repo, cold_a)
            launches = {k: l_hot[k] + l_mix[k] + l_cold[k] for k in SERVE}
            delta = {k: d_hot[k] + d_mix[k] + d_cold[k] for k in d_hot}
            check_serve("(i)", launches, delta)
            if ans != base or {**base, **cold} != {
                    u: want[u] for u in hot + cold_a}:
                raise AssertionError("phase 3l (i): answers != host_read")
            if delta["installs"] < len(hot) + len(cold_a) or delta["fallbacks"]:
                raise AssertionError(f"phase 3l (i): serve {delta}")
            acks_i = durable_acks(repo, wurl, "i", cfg["writes"])
            rep = ctl.report()
            if rep["transitions"] or rep["brownout_reads"] or rep["shed_reads"]:
                raise AssertionError(f"phase 3l (i): service {rep}")
            numbers["healthy"] = dict(
                launches=launches, serve=delta,
                ack_ms_median=statistics.median(acks_i) * 1e3,
                service={k: rep[k] for k in ("state_name", "transitions")})
            log("phase 3l (a)(i) healthy: " + json.dumps(numbers["healthy"]))

            # (ii) brownout: cold installs deferred, hot reads still served
            ctl = service_controller(back, HM_SERVICE_FORCE="brownout")
            resident0 = len(back.serve.residency_report()["resident"])
            cold, l_cold, d_cold = service_reads(ck, repo, cold_b)
            ans, l_hot, d_hot = service_reads(ck, repo, hot_mix,
                                              cfg["readers"])
            check_serve("(ii)", l_hot, d_hot)
            if l_cold["serve_counts"] or d_cold["dispatches"]:
                raise AssertionError(f"phase 3l (ii): a cold read launched "
                                     f"{l_cold}")
            rep = ctl.report()
            resident1 = len(back.serve.residency_report()["resident"])
            if (rep["deferred_installs"] != len(cold_b)
                    or rep["brownout_reads"] != len(cold_b)
                    or resident1 != resident0 or d_cold["installs"]
                    or rep["shed_reads"]):
                raise AssertionError(f"phase 3l (ii): service {rep}, "
                                     f"resident {resident0} -> {resident1}")
            if ans != base or cold != {u: want[u] for u in cold_b}:
                raise AssertionError("phase 3l (ii): answers differ")
            numbers["brownout"] = dict(
                hot_launches=l_hot, hot_serve=d_hot, cold_serve=d_cold,
                resident_docs=resident1,
                service={k: rep[k] for k in (
                    "state_name", "deferred_installs", "brownout_reads",
                    "shed_reads")})
            log("phase 3l (a)(ii) brownout: " + json.dumps(numbers["brownout"]))

            # (iii) shed: per-tenant quotas, typed refusals, paced acks
            ctl = service_controller(
                back, HM_SERVICE_FORCE="shed",
                HM_QUOTA_READS_S=str(cfg["quota_reads_s"]),
                HM_QUOTA_BURST=str(cfg["quota_burst"]))
            tenants = [f"t{i}" for i in range(cfg["tenants"])]
            seen = {t: dict(admitted=0, refused=0, retry_min=None, wall=0.0)
                    for t in tenants}
            lock = threading.Lock()
            errs = []
            snap0 = telemetry.snapshot()
            before = {k: ck.launches[k] for k in SERVE}

            def tenant_reader(n):
                t = tenants[n % len(tenants)]
                mine = hot[n::len(tenants)]
                t0 = time.perf_counter()
                a = r = 0
                retry = None
                k = 0
                while time.perf_counter() - t0 < cfg["shed_s"]:
                    u = mine[k % len(mine)]
                    k += 1
                    try:
                        v = repo.read(u, {"kind": "len", "path": [],
                                          "tenant": t})
                    except Overload as e:
                        r += 1
                        retry = (e.retry_after_s if retry is None
                                 else min(retry, e.retry_after_s))
                        if e.tenant != t or e.state != "shed":
                            errs.append(repr(e))
                        time.sleep(min(max(e.retry_after_s, 1e-3), 0.05))
                        continue
                    a += 1
                    if v != want[u]:
                        errs.append(f"{u}: {v}")
                wall = time.perf_counter() - t0
                with lock:
                    row = seen[t]
                    row["admitted"] += a
                    row["refused"] += r
                    row["wall"] = max(row["wall"], wall)
                    if retry is not None:
                        row["retry_min"] = (retry if row["retry_min"] is None
                                            else min(row["retry_min"], retry))

            run_threads(cfg["tenants"] * cfg["threads_a_tenant"],
                        tenant_reader)
            l_shed = {k: ck.launches[k] - before[k] for k in SERVE}
            d_shed = serve_delta(snap0, telemetry.snapshot())
            paced0 = telemetry.snapshot().get("storage.wal.paced_commits", 0)
            acks_iii = durable_acks(repo, wurl, "iii", cfg["writes"])
            paced = telemetry.snapshot().get(
                "storage.wal.paced_commits", 0) - paced0
            rep = ctl.report()
            if errs:
                raise AssertionError(f"phase 3l (iii): {errs[:3]}")
            refused = sum(row["refused"] for row in seen.values())
            for t, row in seen.items():
                cap = cfg["quota_burst"] + cfg["quota_reads_s"] * row["wall"]
                mine = rep["tenants"].get(t, {})
                if (row["admitted"] > cap or not row["refused"]
                        or row["retry_min"] < 0.1
                        or mine.get("admitted") != row["admitted"]
                        or mine.get("refused") != row["refused"]):
                    raise AssertionError(f"phase 3l (iii): tenant {t} {row} "
                                         f"(cap {cap}), report {mine}")
            tenant_refused = sum(r["refused"] for r in rep["tenants"].values())
            if not (rep["shed_reads"] == refused == tenant_refused):
                raise AssertionError(f"phase 3l (iii): shed_reads "
                                     f"{rep['shed_reads']}, refusals seen "
                                     f"{refused}, tenants {tenant_refused}")
            check_serve("(iii)", l_shed, d_shed)
            stretch = ctl.ack_extra_s()
            med_i, med_iii = statistics.median(acks_i), statistics.median(
                acks_iii)
            if med_iii - med_i < stretch or paced < cfg["writes"]:
                raise AssertionError(f"phase 3l (iii): durable acks "
                                     f"{med_iii * 1e3:.3f} ms against "
                                     f"{med_i * 1e3:.3f} ms healthy, stretch "
                                     f"{stretch * 1e3} ms, paced {paced}")
            numbers["shed"] = dict(
                tenants=seen, launches=l_shed, serve=d_shed,
                ack_ms_median=med_iii * 1e3, ack_ms_healthy=med_i * 1e3,
                ack_stretch_ms=stretch * 1e3, paced_commits=paced,
                service={k: rep[k] for k in (
                    "state_name", "shed_reads", "tenants")})
            log("phase 3l (a)(iii) shed: " + json.dumps(numbers["shed"]))

            # (iv) no force: the ladder on the tier's own p99 from the card
            trace = []
            ctl = service_controller(
                back, trace, HM_SERVICE_FORCE="",
                HM_SERVICE_P99_SLO_MS=str(cfg["slo_ms"]),
                HM_SERVICE_TICK_MS=str(cfg["tick_ms"]),
                HM_BROWNOUT_DOWN_TICKS=str(cfg["down_ticks"]))
            stop = threading.Event()
            outcomes = [[0, 0] for _ in range(cfg["readers"])]

            def storm_reader(n):
                k = n
                try:
                    while not stop.is_set():
                        u = hot[k % len(hot)]
                        k += cfg["readers"]
                        try:
                            v = repo.read(u, {"kind": "len", "path": []})
                        except Overload as e:
                            outcomes[n][1] += 1
                            time.sleep(min(max(e.retry_after_s, 1e-3), 0.05))
                            continue
                        if v != want[u]:
                            errs.append(f"{u}: {v}")
                        outcomes[n][0] += 1
                except Exception as e:  # surfaced after the join
                    errs.append(repr(e))

            threads = [threading.Thread(target=storm_reader, args=(i,))
                       for i in range(cfg["readers"])]
            before = {k: ck.launches[k] for k in SERVE}
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            t_shed = None
            while time.perf_counter() - t0 < cfg["climb_max_s"]:
                if t_shed is None and ctl.state() == SHED:
                    t_shed = time.perf_counter()
                if t_shed is not None and (time.perf_counter() - t_shed
                                           > cfg["hold_after_shed_s"]):
                    break
                time.sleep(0.005)
            stop.set()
            for t in threads:
                t.join()
            t_idle = time.perf_counter()
            l_storm = {k: ck.launches[k] - before[k] for k in SERVE}
            while ctl.state() != HEALTHY:
                if time.perf_counter() - t_idle > cfg["healthy_max_s"]:
                    break
                time.sleep(0.005)
            t_healthy = time.perf_counter()
            rep = ctl.report()
            ctl.close()
            states = [s for _t, s, _sig in trace]
            climb = [s for i, s in enumerate(states)
                     if i == 0 or s != states[i - 1]]
            if t_shed is None or climb[:3] != [HEALTHY, BROWNOUT, SHED]:
                raise AssertionError(f"phase 3l (iv): the ladder went "
                                     f"{[STATE_NAMES[s] for s in climb]}")
            if errs:
                raise AssertionError(f"phase 3l (iv): {errs[:3]}")
            at_shed = next(sig for _t, s, sig in trace if s == SHED)
            # idle ticks: those after the readers stopped whose window saw
            # no read
            idle = [(s, sig) for t, s, sig in trace if t >= t_idle]
            first = next((i for i, (_s, sig) in enumerate(idle)
                          if sig.get("p99_s") == 0.0), len(idle))
            down = next((i - first + 1 for i, (s, _sig) in enumerate(idle)
                         if i >= first and s == HEALTHY), None)
            if (at_shed.get("p99_s", 0.0) <= 0.001 or down is None
                    or down > 2 * cfg["down_ticks"]):
                raise AssertionError(f"phase 3l (iv): p99 at SHED {at_shed}, "
                                     f"idle ticks to healthy {down}")
            if l_storm["serve_counts"] == 0:
                raise AssertionError("phase 3l (iv): serve_counts never "
                                     "launched")
            numbers["signals"] = dict(
                climb=[STATE_NAMES[s] for s in climb],
                t_to_shed_s=t_shed - t0, p99_s_at_shed=at_shed["p99_s"],
                signals_at_shed=at_shed, idle_ticks_to_healthy=down,
                t_to_healthy_s=t_healthy - t_idle, ticks=len(trace),
                values=sum(o[0] for o in outcomes),
                overloads=sum(o[1] for o in outcomes), launches=l_storm,
                transitions=rep["transitions"])
            log("phase 3l (a)(iv) real signals: "
                + json.dumps(numbers["signals"]))
            counts = dict(ck.launches)
        finally:
            repo.close()
    return {k: counts[k] for k in BULK + SERVE if counts[k]}, numbers


def svc_quantile(bounds, counts, q):
    """bench.py `_svc_quantile`: the quantile (ms) of a merged client-side
    histogram, its overflow one step past the last edge."""
    n = sum(counts)
    if n <= 0:
        return None
    seen = 0
    for i, c in enumerate(counts):
        seen += c
        if seen >= q * n:
            bound = bounds[i] if i < len(bounds) else bounds[-1] * 2
            return round(bound * 1e3, 3)
    return round(bounds[-1] * 2 * 1e3, 3)


def service_storm(root: str, device=None) -> dict:
    """Phase 3l (b): bench.py `_config_service` on the port (its warm-up,
    steady round, ramp, 2x-saturation storm with durable writers, recovery
    probes, acked-ledger check and attribution), the daemon on the card;
    returns its numbers and five gates."""
    import signal
    import threading

    from hypermerge_tpu_torch.kernels import _build
    from hypermerge_tpu_torch.net.discovery import DhtNode, DhtSwarm
    from hypermerge_tpu_torch.net.ipc import connect_frontend
    from hypermerge_tpu_torch.repo import Repo

    cfg = STORM
    bounds = cfg["bounds"]
    here = os.path.dirname(os.path.abspath(__file__))
    sock = os.path.join(root, "daemon.sock")
    env = hub_child_env(STORM_ENV)
    boot = DhtNode()
    args = [sys.executable, "-m", HUB_MODULE, os.path.join(root, "repo"),
            sock, "--hub", "--dht", "--dht-bootstrap",
            f"127.0.0.1:{boot.address[1]}"]
    if device is not None:
        args += ["--device", device]
    t_start = time.perf_counter()
    with open(sock + ".err", "w") as err:
        daemon = subprocess.Popen(
            args, env=env, stdout=subprocess.PIPE, stderr=err, text=True,
            start_new_session=True, cwd=here)
    lines: list = []
    clients = []
    peer = sw = close = None
    try:
        line = daemon.stdout.readline()
        if "ready" not in line:
            raise AssertionError(f"phase 3l (b): the daemon did not start: "
                                 f"{line!r}")
        threading.Thread(target=lambda: lines.extend(
            iter(daemon.stdout.readline, "")), daemon=True).start()
        front, close = connect_frontend(sock)
        read_urls = [front.create({"k": i, "pad": "x" * 64})
                     for i in range(cfg["docs"])]
        write_urls = [front.create({"edits": {}})
                      for _ in range(cfg["clients"])]
        got = []
        front.materialize(write_urls[-1], 1, got.append)
        wait_for("the registration round trip", lambda: got, 120, "3l")
        t_up = time.perf_counter() - t_start
        with env_vars(HM_SERVICE="1"):  # as bench.py's peer, on its default
            peer = Repo(memory=True, device=device)
        sw = DhtSwarm(bootstrap=[boot.address])
        peer.set_swarm(sw)
        peer_handles = [peer.open(u) for u in read_urls[:min(4, cfg["docs"])]]
        setup = json.dumps({"read_urls": read_urls, "write_urls": write_urls,
                            "bounds": bounds})
        clients = [subprocess.Popen(
            [sys.executable, "-c", SERVICE_CHILD, sock, str(i)], env=env,
            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True, cwd=here)
            for i in range(cfg["clients"])]
        for c in clients:
            c.stdin.write(setup + "\n")
            c.stdin.flush()
        for c in clients:
            if c.stdout.readline().strip() != "ready":
                raise AssertionError(f"phase 3l (b): a client failed: "
                                     f"{c.stderr.read()[-1000:]}")

        def phase(threads, secs, writes):
            cmd = json.dumps({"op": "phase", "threads": threads,
                              "secs": secs, "writes": 1 if writes else 0})
            for c in clients:
                c.stdin.write(cmd + "\n")
                c.stdin.flush()
            outs = []
            for c in clients:
                line = c.stdout.readline()
                if not line:
                    raise AssertionError(f"phase 3l (b): a client died: "
                                         f"{c.stderr.read()[-1000:]}")
                outs.append(json.loads(line))
            agg = {k: sum(o[k] for o in outs)
                   for k in ("reads", "shed", "errors", "opens", "writes",
                             "write_timeouts")}
            for h in ("rhist", "whist"):
                agg[h] = [sum(o[h][i] for o in outs)
                          for i in range(len(bounds) + 1)]
            agg["secs"] = max(o["secs"] for o in outs)
            agg["acked"] = [o["acked"] for o in outs]
            agg["qps"] = round(agg["reads"] / agg["secs"], 1)
            return agg

        ramp, errors, whist = [], 0, [0] * (len(bounds) + 1)
        writes_total = timeouts = shed_total = 0
        w0 = phase(1, 1.0, writes=False)
        errors += w0["errors"]
        shed_total += w0["shed"]
        time.sleep(0.25)
        r0 = phase(1, cfg["ramp_s"], writes=False)
        errors += r0["errors"]
        shed_total += r0["shed"]
        steady = {"qps": r0["qps"],
                  "read_p50_ms": svc_quantile(bounds, r0["rhist"], 0.50),
                  "read_p99_ms": svc_quantile(bounds, r0["rhist"], 0.99)}
        t = 1
        while t <= cfg["max_threads"]:
            r = phase(t, cfg["ramp_s"], writes=True)
            errors += r["errors"]
            writes_total += r["writes"]
            timeouts += r["write_timeouts"]
            whist = [a + b for a, b in zip(whist, r["whist"])]
            ramp.append({"threads": t, "qps": r["qps"], "shed": r["shed"],
                         "p99_ms": svc_quantile(bounds, r["rhist"], 0.99)})
            if r["shed"] > 0:
                break
            t *= 2
        peak = max(ramp, key=lambda x: x["qps"])
        storm_threads = min(2 * peak["threads"], 2 * cfg["max_threads"])
        r = phase(storm_threads, cfg["hold_s"], writes=True)
        errors += r["errors"]
        writes_total += r["writes"]
        timeouts += r["write_timeouts"]
        whist = [a + b for a, b in zip(whist, r["whist"])]
        storm = {"threads_per_client": storm_threads, "qps": r["qps"],
                 "reads_ok": r["reads"], "reads_shed": r["shed"],
                 "opens": r["opens"],
                 "read_p99_ms": svc_quantile(bounds, r["rhist"], 0.99),
                 "writes_acked": r["writes"]}
        shed_total += sum(x["shed"] for x in ramp) + r["shed"]
        t_end = time.perf_counter()
        recovery_s = None
        probes = []  # [seconds after the storm, reads, shed, p99 ms]
        while time.perf_counter() - t_end < cfg["gate_s"] + 5:
            p = phase(1, 0.4, writes=False)
            errors += p["errors"]
            shed_total += p["shed"]
            p99 = svc_quantile(bounds, p["rhist"], 0.99)
            probes.append([round(time.perf_counter() - t_end, 2), p["reads"],
                           p["shed"], p99])
            if p["shed"] == 0 and p99 is not None and p99 <= cfg["slo_ms"]:
                recovery_s = round(time.perf_counter() - t_end, 2)
                break
        for c in clients:
            c.stdin.write(json.dumps({"op": "quit"}) + "\n")
            c.stdin.flush()
        for c in clients:
            c.wait(timeout=30)
        acked_counts = r["acked"]
        acked_lost = 0
        for i, url in enumerate(write_urls):
            want = acked_counts[i]
            h = front.open(url)
            deadline = time.time() + 60
            edits = {}
            while time.time() < deadline:
                try:
                    v = h.value(timeout=0.5)
                except TimeoutError:
                    v = None
                edits = (v or {}).get("edits", {})
                if len(edits) >= want:
                    break
                time.sleep(0.05)
            acked_lost += sum(1 for s_ in range(want)
                              if f"c{i}.{s_}" not in edits)
        tele = []
        front.telemetry(tele.append)
        wait_for("the telemetry reply", lambda: tele, 30, "3l")
        payload = tele[0] or {}
        svc = payload.get("service") or {}
        counters = payload.get("counters") or {}
        tenants = svc.get("tenants") or {}
        refused_sum = sum(row.get("refused", 0) for row in tenants.values())
        shed_reads = int(svc.get("shed_reads", 0))
        transitions = int(svc.get("transitions", 0))
        gates = {
            "reads_never_error": errors == 0,
            "acked_lost_zero": acked_lost == 0 and sum(acked_counts) > 0,
            "recovery_within_gate": (recovery_s is not None
                                     and recovery_s <= cfg["gate_s"]),
            "shed_order_ok": shed_reads == 0 or transitions >= 2,
            "attributed": refused_sum == shed_reads == shed_total,
        }
        # the daemon's own process holds the card and the built kernel
        with open(f"/proc/{daemon.pid}/maps") as f:
            maps = f.read()
        lib = str(_build.target("serve_counts"))
        mapped = {"libcuda": "libcuda" in maps,
                  os.path.basename(lib): lib in maps}
        peer_synced = sum(1 for h in peer_handles
                          if handle_value(h) is not None)
        return dict(
            clients=cfg["clients"], docs=cfg["docs"], slo_ms=cfg["slo_ms"],
            t_daemon_up_s=t_up, steady=steady, ramp=ramp,
            saturation_qps=peak["qps"],
            sat_threads_per_client=peak["threads"], storm=storm,
            recovery_to_slo_s=recovery_s, recovery_gate_s=cfg["gate_s"],
            recovery_probes=probes,
            writes_acked=writes_total, write_timeouts=timeouts,
            write_p50_ms=svc_quantile(bounds, whist, 0.50),
            write_p99_ms=svc_quantile(bounds, whist, 0.99),
            acked_lost=acked_lost, reads_errors=errors,
            reads_shed=shed_total,
            service={"state": svc.get("state_name"),
                     "transitions": transitions, "shed_reads": shed_reads,
                     "brownout_reads": int(svc.get("brownout_reads", 0)),
                     "deferred_installs": int(svc.get("deferred_installs",
                                                      0)),
                     "tenants": tenants},
            shed_reached=shed_reads > 0,
            paced_commits=int(counters.get("storage.wal.paced_commits", 0)),
            overload_shed=int(counters.get("serve.overload_shed", 0)),
            serve_dispatches=int(counters.get("serve.dispatches", 0)),
            daemon_maps=mapped, peer_docs_replicated=peer_synced,
            gates=gates, gated_ok=all(gates.values()))
    finally:
        for c in clients:
            if c.poll() is None:
                c.kill()
            c.wait(timeout=30)
        if close is not None:
            close()
        if peer is not None:
            peer.close()
        if sw is not None:
            sw.destroy()
        boot.close()
        if daemon.poll() is None:
            daemon.terminate()
            try:
                daemon.wait(timeout=30)
            except subprocess.TimeoutExpired:
                pass
        try:
            os.killpg(daemon.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        if daemon.poll() is None:
            daemon.wait(timeout=30)


def service_path(ck, corpus, urls, device=None) -> tuple:
    """Phase 3l on the card: (a) in this process, then (b) the storm.
    Returns ((a)'s launch counts, the numbers)."""
    card = card_line()
    t0 = time.perf_counter()
    launches, inproc = service_inproc(ck, corpus, urls, device)
    log(f"phase 3l (a) launches {launches} [{card}]")
    with tempfile.TemporaryDirectory(prefix="hm-service-") as root:
        storm = service_storm(root, device)
    log("phase 3l (b) _config_service: " + json.dumps(storm) + f" [{card}]")
    if not storm["gated_ok"]:
        raise AssertionError(
            f"phase 3l (b): gates {storm['gates']}; recovery "
            f"{storm['recovery_to_slo_s']} s, probes "
            f"{storm['recovery_probes']}, storm {storm['storm']}, "
            f"service {storm['service']} [{card}]")
    if device is None and not all(storm["daemon_maps"].values()):
        raise AssertionError(f"phase 3l (b): the daemon maps "
                             f"{storm['daemon_maps']}")
    wall = time.perf_counter() - t0
    log(f"phase 3l check: (a) healthy, brownout ({SERVICE['cold']} installs "
        f"deferred), shed (quotas, typed refusals, acks paced by "
        f"{inproc['shed']['ack_stretch_ms']} ms) and the ladder on its own "
        f"signals ({inproc['signals']['climb']}, back to healthy in "
        f"{inproc['signals']['idle_ticks_to_healthy']} idle ticks); (b) "
        f"saturation {storm['saturation_qps']} reads/s at "
        f"{storm['sat_threads_per_client']} threads a client, storm "
        f"{storm['storm']['qps']} reads/s p99 {storm['storm']['read_p99_ms']}"
        f" ms, recovery {storm['recovery_to_slo_s']} s, transitions "
        f"{storm['service']['transitions']}, SHED reached "
        f"{storm['shed_reached']}, serve.dispatches "
        f"{storm['serve_dispatches']}, gates {storm['gates']}; phase wall "
        f"{wall:.1f} s [{card}]")
    return launches, dict(card=card, inproc=inproc, storm=storm)


# the hyperfile slice (phase 3m): files/ between two card repos over
# encrypted, authenticated TcpSwarm. (a) A writes a hyperfile at each size
# where chunking changes shape (empty, one byte, either side of one
# 62 KiB block, 1 MiB: 17 data blocks) and a doc naming each; B opens each
# doc, reads the url from it and fetches the file with progress events;
# B is closed and reopened on the card and its bulk open of the six docs is
# counted (pack_prefix and materialize_wire launch; no file feed reaches a
# sidecar or a slab), and every file reads back from B's disk. (b) B's file
# server on a unix socket: A's files over HTTP, a file A writes after the
# reopen fetched through the server from the swarm under an explicit
# HM_FILE_FETCH_TIMEOUT_S, an upload through `repo.files.write`, and an
# unknown id's 404 that leaves no feed behind.
FILES = dict(sizes=(0, 1, 62 * 1024 - 1, 62 * 1024, 62 * 1024 + 1, 1 << 20),
             edits=3, late_size=1 << 20, seed=21, timeout_s=180,
             mime="application/x-hm-smoke")
# the server's remote wait in 3m (b), set for the phase and printed: the
# default (15 s) is near what a 1 MiB fetch spends in Python's
# ChaCha20-Poly1305 on both sides of a host without libsodium; the 404
# probe runs under a short one, since the server waits that long for an id
# no peer holds
FILES_FETCH_TIMEOUT_S = "120"
FILES_MISS_TIMEOUT_S = "1"


def file_bytes(size: int, seed: int) -> bytes:
    import numpy as np

    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, size, dtype=np.uint8).tobytes()


def odd_chunks(data: bytes, seed: int) -> list:
    """`data` as odd-sized chunks, some above one 62 KiB block (the write
    path splits them) and some far below (kept whole)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    out, i = [], 0
    while i < len(data):
        n = 2 * int(rng.integers(0, 62 * 1024)) + 1
        out.append(data[i:i + n])
        i += n
    return out


def signing_routes() -> dict:
    """Which ed25519 the feeds' keys and signatures take here: the native
    library's libsodium entries, OpenSSL's libcrypto (utils/ossl.py,
    signing only) or the pure-Python RFC 8032 code."""
    from hypermerge_tpu_torch import native
    from hypermerge_tpu_torch.utils import ossl

    seed = b"\x01" * 32
    sodium = native.ed25519_public(seed) is not None
    return dict(
        keypair="native libsodium" if sodium else "ed25519 (pure Python)",
        sign=("native libsodium" if sodium
              else "libcrypto (utils/ossl.py)" if ossl.load() is not None
              else "ed25519 (pure Python)"))


def fetch_file(repo, url: str, timeout_s: float) -> dict:
    """Fetch one hyperfile into `repo` from the swarm (FileStore.read with
    a timeout: blocks stream as replication lands them) with progress
    events; (bytes, header, wall, progress events)."""
    from hypermerge_tpu_torch.utils.ids import url_to_id

    fs = repo.back.get_file_store()
    fid = url_to_id(url)
    progress = []
    stop = fs.subscribe_progress(
        fid, lambda blocks, nbytes: progress.append((blocks, nbytes)))
    try:
        t0 = time.perf_counter()
        got = fs.read_bytes(fid, timeout=timeout_s)
        wall = time.perf_counter() - t0
        header = fs.header_wait(fid, timeout=timeout_s)
    finally:
        stop()
    return dict(data=got, header=header, wall=wall, progress=progress)


def files_write(ra) -> tuple:
    """Phase 3m (a) 2: A writes the hyperfiles (even ones as bytes, odd ones
    as odd-sized chunks) and a doc naming each, with a few edits. Returns
    ([(header, bytes)], the doc urls, the wall)."""
    cfg = FILES
    fs = ra.back.get_file_store()
    files, urls = [], []
    t0 = time.perf_counter()
    for i, size in enumerate(cfg["sizes"]):
        data = file_bytes(size, cfg["seed"] + i)
        src = data if i % 2 == 0 else odd_chunks(data, cfg["seed"] + i)
        header = fs.write(src, cfg["mime"])
        if header.sha256 != hashlib.sha256(data).hexdigest():
            raise AssertionError(f"phase 3m (a): A's header of file {i} does "
                                 "not hash its bytes")
        files.append((header, data))
        url = ra.create({"file": header.url, "bytes": size, "edits": []})
        for k in range(cfg["edits"]):
            ra.change(url, lambda d, k=k: d["edits"].append(k))
        urls.append(url)
    return files, urls, time.perf_counter() - t0


def files_fetch(ra, sa, files, doc_urls, b_dir: str, device=None) -> list:
    """Phase 3m (a) 3: B, a fresh `Repo(path)` on TcpSwarm, opens each doc,
    reads the file's url from it and fetches the file with progress events;
    bytes, header and block count equal A's. Returns the per-file numbers."""
    from hypermerge_tpu_torch.net.tcp import TcpSwarm
    from hypermerge_tpu_torch.repo import Repo
    from hypermerge_tpu_torch.utils.ids import url_to_id

    cfg = FILES
    rb = Repo(path=b_dir, device=device)
    sb = TcpSwarm()
    fetched = []
    try:
        rb.set_swarm(sb)
        sb.connect(sa.address)
        # open_many, as a replica opens a corpus: no writer actor is
        # minted, so the docs stay single-writer for the reopen's pack
        handles = rb.open_many(doc_urls)
        for i, h in enumerate(handles):
            wait_for(f"doc {i} on B", lambda h=h: len(
                (h.value(timeout=cfg["timeout_s"]) or {}).get("edits", []))
                >= cfg["edits"], cfg["timeout_s"], "3m")
            header, data = files[i]
            file_url = h.value()["file"]
            if file_url != header.url:
                raise AssertionError(f"phase 3m (a): doc {i} names "
                                     f"{file_url}, A wrote {header.url}")
            got = fetch_file(rb, file_url, cfg["timeout_s"])
            if got["data"] != data or got["header"] != header:
                raise AssertionError(f"phase 3m (a): file {i} ({len(data)} "
                                     "bytes) fetched by B differs from A's")
            held = rb.back.feeds.get_feed(url_to_id(file_url)).length
            if (held != header.blocks + 1 or not got["progress"]
                    or got["progress"][-1][0] != held):
                raise AssertionError(f"phase 3m (a): file {i}: progress "
                                     f"{got['progress'][-3:]}, {held} blocks")
            fetched.append(dict(
                bytes=header.size, blocks=header.blocks,
                fetch_s=got["wall"],
                mib_s=(header.size / 2**20 / got["wall"]
                       if header.size else None),
                progress_events=len(got["progress"])))
        check_pinned(ra, rb, "(a)", "3m")
        if ([plain_value(rb.doc(u)) for u in doc_urls]
                != [plain_value(ra.doc(u)) for u in doc_urls]):
            raise AssertionError("phase 3m (a): B's docs differ from A's")
    finally:
        rb.close()
        sb.destroy()
    return fetched


def files_reopen(ck, ra, files, doc_urls, b_dir: str, device=None) -> tuple:
    """Phase 3m (a) 4-5: B reopened on the card, without a swarm; the launch
    counts set to 0 just before `open_many` + `fetch_bulk_summaries` of the
    docs (whose feeds came over the swarm beside the file feeds) and read
    just after: pack_prefix and materialize_wire launched, every doc equal
    to A's, no file feed in the sidecar slab or among the actors, and every
    file read back from B's disk (timeout 0). Returns (the launches, the
    numbers)."""
    import torch

    from hypermerge_tpu_torch.repo import Repo
    from hypermerge_tpu_torch.utils.ids import url_to_id, validate_doc_url

    for k in ck.launches:
        ck.launches[k] = 0
    t0 = time.perf_counter()
    rb = Repo(path=b_dir, device=device)
    try:
        rb.open_many(doc_urls)
        summ = rb.back.fetch_bulk_summaries()
        if device is None:
            torch.cuda.synchronize()
        t_reopen = time.perf_counter() - t0
        launches = {k: v for k, v in ck.launches.items() if v}
        stats = dict(rb.back.last_bulk_stats)
        if (sorted(summ.doc_ids) != sorted(map(validate_doc_url, doc_urls))
                or [plain_value(rb.doc(u)) for u in doc_urls]
                != [plain_value(ra.doc(u)) for u in doc_urls]):
            raise AssertionError("phase 3m (a): B's reopened docs differ "
                                 "from A's")
        fs = rb.back.get_file_store()
        t0 = time.perf_counter()
        for header, data in files:
            fid = url_to_id(header.url)
            if fs.read_bytes(fid) != data or fs.header(fid) != header:
                raise AssertionError(f"phase 3m (a): the file of {len(data)} "
                                     "bytes differs on B's disk")
        t_local = time.perf_counter() - t0
        file_ids = {url_to_id(h.url) for h, _ in files}
        slab = rb.back._col_slab
        leaked = file_ids & (set(slab.feed_names() if slab else ())
                             | set(rb.back.actors))
        if leaked:
            raise AssertionError(f"phase 3m (a): file feeds reached the "
                                 f"sidecar slab or the actors: {leaked}")
    finally:
        rb.close()
    for k in BULK:
        if not launches.get(k):
            raise AssertionError(f"phase 3m (a): {k} never launched in B's "
                                 f"reopen: {launches}")
    return launches, dict(
        t_reopen_s=t_reopen, t_local_read_s=t_local, launches=launches,
        reopen_stats={k: stats.get(k) for k in ("docs", "fast", "pipeline",
                                                "t_io", "t_pack")})


def files_server(ra, sa, files, b_dir: str, device=None) -> dict:
    """Phase 3m (b): B reopened once more, on TcpSwarm to A, with its file
    server on a unix socket under a short temporary directory. Returns the
    numbers."""
    from hypermerge_tpu_torch.net.tcp import TcpSwarm
    from hypermerge_tpu_torch.repo import Repo
    from hypermerge_tpu_torch.utils import keys as keymod
    from hypermerge_tpu_torch.utils.ids import url_to_id

    cfg = FILES
    sock_dir = tempfile.mkdtemp(prefix="hm-fs-")
    sock = os.path.join(sock_dir, "files.sock")
    if len(sock.encode()) > 107:
        raise AssertionError(f"phase 3m (b): socket path over 107 bytes: "
                             f"{sock}")
    rb = Repo(path=b_dir, device=device)
    sb = TcpSwarm()
    try:
        rb.set_swarm(sb)
        sb.connect(sa.address)
        rb.start_file_server(sock)
        client = rb.files
        if client is None:
            raise AssertionError("phase 3m (b): no FileServerClient after "
                                 "start_file_server")
        t0 = time.perf_counter()
        for header, data in files:
            got_header, body = client.read(header.url)
            if body != data or got_header.sha256 != header.sha256 \
                    or got_header.blocks != header.blocks:
                raise AssertionError(f"phase 3m (b): HTTP read of "
                                     f"{len(data)} bytes differs")
        t_http = time.perf_counter() - t0
        late = file_bytes(cfg["late_size"], cfg["seed"] + 100)
        late_header = ra.back.get_file_store().write(late, cfg["mime"])
        with env_vars(HM_FILE_FETCH_TIMEOUT_S=FILES_FETCH_TIMEOUT_S):
            t0 = time.perf_counter()
            got_header, body = client.read(late_header.url)
            t_late = time.perf_counter() - t0
        if body != late or got_header.sha256 != late_header.sha256:
            raise AssertionError("phase 3m (b): the late file fetched "
                                 "through the server differs from A's")
        up = file_bytes(200 * 1024, cfg["seed"] + 200)
        up_header = client.write(up, cfg["mime"])
        _h, body = client.read(up_header.url)
        up_id = url_to_id(up_header.url)
        if body != up or rb.back.meta.file_metadata(up_id) != {
                "type": "File", "bytes": len(up), "mimeType": cfg["mime"]}:
            raise AssertionError("phase 3m (b): the upload did not read back "
                                 "or did not land in meta.files")
        bogus = keymod.create().public_key
        bogus_url = f"hyperfile:/{bogus}"
        with env_vars(HM_FILE_FETCH_TIMEOUT_S=FILES_MISS_TIMEOUT_S):
            for call in (client.header, client.read):
                try:
                    call(bogus_url)
                except FileNotFoundError:
                    pass
                else:
                    raise AssertionError("phase 3m (b): an unknown id was "
                                         "answered")
        if (rb.back.feeds.get_feed(bogus) is not None
                or bogus in rb.back.feed_info.all_public_ids()):
            raise AssertionError("phase 3m (b): the 404 left a feed behind")
        check_pinned(ra, rb, "(b)", "3m")
    finally:
        rb.close()
        sb.destroy()
        shutil.rmtree(sock_dir, ignore_errors=True)
    return dict(http_read_s=t_http, late_bytes=len(late),
                late_blocks=late_header.blocks, late_fetch_s=t_late,
                late_mib_s=len(late) / 2**20 / t_late,
                upload_bytes=len(up), fetch_timeout_s=FILES_FETCH_TIMEOUT_S,
                miss_timeout_s=FILES_MISS_TIMEOUT_S,
                socket_path_bytes=len(sock.encode()))


def files_path(ck, device=None) -> tuple:
    """Phase 3m on the card (or `device`): (a) write, fetch and reopen, (b)
    the file server. Returns (the launch counts of B's reopen, the
    numbers)."""
    from hypermerge_tpu_torch.net.tcp import TcpSwarm
    from hypermerge_tpu_torch.repo import Repo

    card = card_line() if device is None else str(device)
    crypto = transport_crypto()
    routes = signing_routes()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="hm-files-") as root:
        b_dir = os.path.join(root, "b")
        ra = Repo(path=os.path.join(root, "a"), device=device)
        sa = TcpSwarm()
        try:
            ra.set_swarm(sa)
            files, doc_urls, t_write = files_write(ra)
            fetched = files_fetch(ra, sa, files, doc_urls, b_dir, device)
            launches, reopen = files_reopen(ck, ra, files, doc_urls, b_dir,
                                            device)
            total = sum(f["bytes"] for f in fetched)
            t_fetch = sum(f["fetch_s"] for f in fetched)
            fetch = dict(files=fetched, t_write_a_s=t_write,
                         fetch_total_bytes=total, fetch_total_s=t_fetch,
                         fetch_mib_s=total / 2**20 / t_fetch, **reopen)
            log("phase 3m (a) fetch + reopen: " + json.dumps(fetch)
                + f" [{card}]")
            server = files_server(ra, sa, files, b_dir, device)
        finally:
            ra.close()
            sa.destroy()
    wall = time.perf_counter() - t0
    log("phase 3m (b) file server: " + json.dumps(server) + f" [{card}]")
    log(f"phase 3m check: {len(files)} hyperfiles "
        f"({[f['bytes'] for f in fetched]} bytes) fetched by B over "
        f"TcpSwarm at {fetch['fetch_mib_s']:.3f} MiB/s, byte-equal with "
        f"progress events; B reopened in {fetch['t_reopen_s']:.3f} s "
        f"({launches}) with every doc equal to A's and every file read from "
        f"its disk; the server read each over HTTP, fetched a "
        f"{server['late_bytes']}-byte file from the swarm in "
        f"{server['late_fetch_s']:.3f} s (HM_FILE_FETCH_TIMEOUT_S="
        f"{FILES_FETCH_TIMEOUT_S}), took an upload into meta.files and "
        f"answered an unknown id 404 with no feed left; transport crypto: "
        f"{crypto}; keys {routes['keypair']}, signatures {routes['sign']}; "
        f"phase wall {wall:.1f} s [{card}]")
    return launches, dict(card=card, transport_crypto=crypto,
                          signing=routes, fetch=fetch, server=server,
                          wall_s=wall)


# the concurrency analysis on the card (phase 3n): a child process started
# with HM_LOCKDEP=1 and HM_RACEDEP=1 in its environment, so that every lock
# the port makes is a DepLock and every field of the guard map carries
# racedep's descriptor from the first import on; the rest of the script runs
# uninstrumented. The child runs (a) a negative control: a seeded AB/BA order
# and a seeded unguarded write, both of which must be reported; then (b)
# phase 3d's bulk open on a copy of its corpus and LOCKDEP["reads"] `len`
# reads from LOCKDEP["readers"] threads through the batcher, (c) a peer's
# 128-op burst into each of 2 bulk-opened docs of 8,192 ops inside one
# raised tick window (one [2, 16384] dispatch: doc_kernel.cu's many-block
# route, which N above 8,192 takes; HM_LIVE_INC_BUDGET=0 and
# HM_DEVICE_MIN_CELLS=0, since two docs' 32,768 cells are under the default
# cutovers), (d) 3i (a)'s config 2 at its defaults (B's remote ticks). (b) and
# (c) are held to the same paths run uninstrumented here, on copies, first;
# (d) to the plain replay, as in 3i.
LOCKDEP = dict(readers=8, reads=2000, budget_s=90.0, timeout_s=600)
LOCKDEP_LIVE = dict(LIVE_GROUP, n_docs=2, n_ops=8_192, bucket=16384)
LOCKDEP_CLASSES = ("kernels.build", "kernels.launches", "live.engine",
                   "doc.emit", "serve.cache")
LOCKDEP_KERNELS = ("pack_prefix", "materialize_wire", "serve_counts",
                   "materialize_live")


def lockdep_open_reads(ck, corpus: str, urls: list,
                       device=None) -> dict:
    """Phase 3n (b): `Repo(path)` over `corpus` on the card, `open_many` +
    `fetch_bulk_summaries` with the launch counts set to 0 just before,
    then LOCKDEP["reads"] `len` reads (phase 3d's mix: nine in ten of its
    hot set) from LOCKDEP["readers"] threads through the batcher. Returns
    the summaries' digest, the answers, the walls and the counts."""
    import random

    import torch

    from hypermerge_tpu_torch.repo import Repo
    from hypermerge_tpu_torch.utils.ids import validate_doc_url

    repo = Repo(path=corpus, device=device)
    try:
        for k in ck.launches:
            ck.launches[k] = 0
        t0 = time.perf_counter()
        repo.open_many(urls)
        summ = repo.back.fetch_bulk_summaries()
        open_s = time.perf_counter() - t0
        rows = summary_rows(summ, [validate_doc_url(u) for u in urls])
        rng = random.Random(READ["seed"])
        hot = urls[: READ["hot"]]
        mix = [hot[rng.randrange(len(hot))] if rng.random() < 0.9
               else urls[rng.randrange(len(urls))]
               for _ in range(LOCKDEP["reads"])]
        query = {"kind": "len", "path": []}
        answers = [None] * len(mix)

        def reader(n):
            for i in range(n, len(mix), LOCKDEP["readers"]):
                answers[i] = repo.read(mix[i], query)

        read_s = run_threads(LOCKDEP["readers"], reader)
        if device is None:
            torch.cuda.synchronize()
        counts = {k: v for k, v in ck.launches.items() if v}
    finally:
        repo.close()
    if any(a is None for a in answers):
        raise AssertionError("phase 3n (b): a read answered None")
    digest = hashlib.sha256(repr(sorted(rows.items())).encode()).hexdigest()
    return dict(digest=digest, answers=answers, open_s=open_s,
                read_s=read_s, launches=counts)


def lockdep_live_edits(urls: list) -> list:
    """The peer's edits of phase 3n (c), one list a doc (phase 3f's group
    traffic at LOCKDEP_LIVE's size)."""
    from hypermerge_tpu_torch.ops import synth
    from hypermerge_tpu_torch.utils.ids import validate_doc_url

    cfg = LOCKDEP_LIVE
    hists = [synth.synth_changes(cfg["n_ops"], n_actors=1,
                                 ops_per_change=cfg["ops_per_change"],
                                 text_frac=cfg["text_frac"],
                                 seed=cfg["seed"] + t)
             for t in range(cfg["n_docs"])]
    return [synth.synth_live_edits(hists[i], 1 + cfg["edits"], seed=i,
                                   rename={"actor00": validate_doc_url(u)})
            for i, u in enumerate(urls)]


def lockdep_live(ck, where: str, urls: list, device=None) -> dict:
    """Phase 3n (c): `drive_live` over the bulk-opened docs at `where`
    (the launch counts set to 0 just before); the burst's one dispatch of
    LOCKDEP_LIVE's shape must take the many-block route. Returns the
    outcome's digest, the numbers and the counts."""
    import torch

    cfg = LOCKDEP_LIVE
    for k in ck.launches:
        ck.launches[k] = 0
    with env_vars(HM_LIVE_INC_BUDGET="0"):
        outcome, numbers, shapes, _captured = drive_live(
            ck, where, urls, lockdep_live_edits(urls), cfg["chunk"],
            device=device, tick_ms=cfg["tick_ms"], min_cells=0)
    counts = {k: v for k, v in ck.launches.items() if v}
    shape = (cfg["n_docs"], cfg["bucket"])
    if shape not in shapes:
        raise AssertionError(f"phase 3n (c): no {shape} dispatch: {shapes}")
    route = (ck.DOC_ROUTE_MANY_BLOCK if device is not None
             else ck.doc_route(*shape, torch.device("cuda", 0)))
    if route != ck.DOC_ROUTE_MANY_BLOCK:
        raise AssertionError(f"phase 3n (c): {shape} takes route {route}, "
                             "not the many-block route")
    digest = hashlib.sha256(
        json.dumps(outcome, sort_keys=True, default=str).encode()
    ).hexdigest()
    return dict(digest=digest, shapes=[list(s) for s in shapes],
                numbers=numbers, launches=counts)


def lockdep_negative_control(lockdep) -> dict:
    """Phase 3n (a): a seeded AB/BA order on two threads (never at once,
    so no deadlock can fire) and a seeded write to a guarded field
    without its lock; both must be reported. Then the observations are
    dropped, so that what follows is checked from a clean slate."""
    import threading

    from hypermerge_tpu_torch.serve.resident import ResidencyCache

    a, b = lockdep.make_rlock("net.network"), lockdep.make_rlock("net.swarm")
    cache = ResidencyCache()

    def nested():
        with a:
            with b:
                pass

    def inverted():
        with b:
            with a:
                pass

    def guarded():
        with cache._lock:
            cache._use += 1

    def unguarded():
        cache._use += 1

    for fn in (nested, inverted, guarded, unguarded):
        t = threading.Thread(target=fn)
        t.start()
        t.join()
    rep = lockdep.report()
    cycles = [c["cycle"] for c in rep["cycles"]]
    lockset = [v["msg"] for v in rep["violations"] if v["kind"] == "lockset"]
    if not cycles or not lockset:
        raise AssertionError(f"phase 3n (a): the seeded faults were not "
                             f"reported: {rep}")
    lockdep.reset()
    return dict(cycles=cycles, lockset=lockset)


def lockdep_child(corpus: str, live_dir: str, args_path: str,
                  out_path: str, device=None) -> int:
    """Phase 3n's instrumented process (`--lockdep-child`): (a)-(d), the
    checker's report and the counters, as one JSON file at `out_path`
    (on the card, or `device` in a CPU rehearsal)."""
    import torch

    from hypermerge_tpu_torch import telemetry
    from hypermerge_tpu_torch.analysis import lockdep
    from hypermerge_tpu_torch.ops import crdt_kernels as ck

    if not (lockdep.enabled() and lockdep.racedep_enabled()):
        raise AssertionError("phase 3n: the child runs without HM_LOCKDEP=1 "
                             "and HM_RACEDEP=1")
    if device is None and not torch.cuda.is_available():
        raise AssertionError("phase 3n: no CUDA device in the child")
    lockdep.install_racedep()
    with open(args_path) as fh:
        args = json.load(fh)
    t0 = time.perf_counter()
    control = lockdep_negative_control(lockdep)
    opened = lockdep_open_reads(ck, corpus, args["urls"], device)
    log(f"phase 3n (b) instrumented: open {opened['open_s']:.3f} s, "
        f"{LOCKDEP['reads']} reads {opened['read_s']:.3f} s, launches "
        f"{opened['launches']}")
    burst = lockdep_live(ck, live_dir, args["live_urls"], device)
    log(f"phase 3n (c) instrumented: burst {burst['numbers']['burst_s']:.3f}"
        f" s, dispatches {burst['shapes']}, launches {burst['launches']}")
    for k in ck.launches:
        ck.launches[k] = 0
    conv = config2_run(ck, "lockdep", {}, device)
    log(f"phase 3n (d) instrumented: config 2 converged in "
        f"{conv['wall_s']:.3f} s, launches {conv['launches']}")
    rep = lockdep.report()
    snap = telemetry.snapshot()
    out = dict(
        control=control, classes=lockdep.classes_seen(),
        edges=[f"{e['from']}->{e['to']}" for e in rep["edges"]],
        findings=rep["cycles"] + rep["violations"],
        racedep_attrs=len(lockdep._race_installed),
        blocking={k: v for k, v in snap.items()
                  if k.startswith("lock.held_blocking_ms.")},
        racedep_violations=snap.get("lock.racedep_violations", 0),
        open=opened, live=burst,
        config2=dict(wall_s=conv["wall_s"], launches=conv["launches"],
                     edits_a_doc=conv["edits_a_doc"]),
        child_s=time.perf_counter() - t0,
    )
    with open(out_path, "w") as fh:
        json.dump(out, fh)
    return 0


def lockdep_path(ck, corpora: tuple, urls: list, device=None) -> tuple:
    """Phase 3n: (b) and (c) uninstrumented here, (b) on the first of
    `corpora` (two copies of phase 3d's corpus, made with 3d's), then the
    instrumented child on the second and on a copy of (c)'s, held to
    their answers. Returns (the child's launch counts of the four
    kernels' paths, the numbers). `device="cpu"` is the CPU rehearsal:
    the plain versions run and no launch is counted."""
    import torch

    card = card_line() if device is None else str(device)
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="hm-lockdep-") as root:
        cfg = LOCKDEP_LIVE
        live_dir = os.path.join(root, "live")
        live_urls, _hists = write_live_corpus(
            live_dir, cfg["n_docs"], cfg["n_ops"], cfg["ops_per_change"],
            cfg["text_frac"], cfg["seed"])
        t_setup = time.perf_counter() - t_phase
        plain_open = lockdep_open_reads(ck, corpora[0], urls, device)
        plain_live = lockdep_live(ck, live_dir, live_urls, device)
        if device is None:
            torch.cuda.synchronize()
        args_path = os.path.join(root, "args.json")
        out_path = os.path.join(root, "out.json")
        with open(args_path, "w") as fh:
            json.dump(dict(urls=urls, live_urls=live_urls), fh)
        env = dict(os.environ, HM_LOCKDEP="1", HM_RACEDEP="1")
        t0 = time.perf_counter()
        run = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--lockdep-child",
             corpora[1], live_dir + "-twin", args_path, out_path]
            + ([] if device is None else [str(device)]),
            env=env, timeout=LOCKDEP["timeout_s"])
        child_wall = time.perf_counter() - t0
        if run.returncode != 0:
            raise AssertionError(f"phase 3n: the instrumented child exited "
                                 f"{run.returncode}")
        with open(out_path) as fh:
            dep = json.load(fh)
    wall = time.perf_counter() - t_phase
    if dep["open"]["digest"] != plain_open["digest"]:
        raise AssertionError("phase 3n (b): instrumented summaries differ")
    if dep["open"]["answers"] != plain_open["answers"]:
        raise AssertionError("phase 3n (b): instrumented reads differ")
    if dep["live"]["digest"] != plain_live["digest"]:
        raise AssertionError("phase 3n (c): instrumented live docs differ")
    launches = dict(dep["open"]["launches"])
    for part in (dep["live"]["launches"], dep["config2"]["launches"]):
        for k, v in part.items():
            launches[k] = launches.get(k, 0) + v
    missing = [c for c in LOCKDEP_CLASSES if c not in dep["classes"]
               and (device is None or not c.startswith("kernels."))]
    zero = [k for k in LOCKDEP_KERNELS
            if device is None and not launches.get(k)]
    engine_ms = dep["blocking"].get("lock.held_blocking_ms.live_engine", 0.0)
    numbers = dict(
        card=card, classes=dep["classes"], n_edges=len(dep["edges"]),
        edges=dep["edges"], findings=dep["findings"],
        racedep_attrs=dep["racedep_attrs"], blocking=dep["blocking"],
        control=dict(cycles=len(dep["control"]["cycles"]),
                     lockset=len(dep["control"]["lockset"])),
        launches={k: launches.get(k, 0) for k in LOCKDEP_KERNELS},
        open_s=dep["open"]["open_s"], plain_open_s=plain_open["open_s"],
        open_ratio=dep["open"]["open_s"] / plain_open["open_s"],
        read_s=dep["open"]["read_s"], plain_read_s=plain_open["read_s"],
        burst_s=dep["live"]["numbers"]["burst_s"],
        plain_burst_s=plain_live["numbers"]["burst_s"],
        live_shapes=dep["live"]["shapes"],
        config2_wall_s=dep["config2"]["wall_s"],
        setup_s=t_setup, child_wall_s=child_wall, child_s=dep["child_s"],
        wall_s=wall,
    )
    log("lockdep " + json.dumps(numbers))
    if dep["findings"]:
        raise AssertionError(f"phase 3n: lockdep findings: "
                             f"{dep['findings'][:4]}")
    if engine_ms > 0:
        raise AssertionError(f"phase 3n: {engine_ms} ms blocked under "
                             "live.engine")
    if missing:
        raise AssertionError(f"phase 3n: classes never taken: {missing}")
    if zero:
        raise AssertionError(f"phase 3n: kernels never launched: {zero}")
    log(f"phase 3n check: the seeded AB/BA order and unguarded write "
        f"reported; bulk open, {LOCKDEP['reads']} reads, the [2, "
        f"{LOCKDEP_LIVE['bucket']}] burst and config 2 clean under "
        f"HM_LOCKDEP=1 HM_RACEDEP=1 ({len(dep['edges'])} edges, "
        f"{dep['racedep_attrs']} fields instrumented) and equal to their "
        f"uninstrumented answers; open {numbers['open_ratio']:.2f}x "
        f"uninstrumented; phase wall {wall:.1f} s [{card}]")
    if wall > LOCKDEP["budget_s"]:
        raise AssertionError(f"phase 3n took {wall:.1f} s, over its "
                             f"{LOCKDEP['budget_s']} s")
    return launches, numbers


def lockdep_main() -> int:
    """`--lockdep`: phase 3n alone on the card (phase 3d's corpus written
    first, the kernels built)."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from hypermerge_tpu_torch import native
    from hypermerge_tpu_torch.kernels import _build
    from hypermerge_tpu_torch.ops import crdt_kernels as ck
    from hypermerge_tpu_torch.ops.corpus import make_corpus

    log(card_line())
    _build.build()
    with tempfile.TemporaryDirectory(prefix="hm-read-") as root:
        sign = bool(native.caps() & native.CAP_SODIUM)
        corpus = os.path.join(root, "corpus")
        urls = make_corpus(corpus, READ["n_docs"], READ["n_ops"], sign=sign)
        shutil.copytree(corpus, corpus + "-dep")
        lockdep_path(ck, (corpus, corpus + "-dep"), urls)
    return 0


# the command-line tools on the card (phase 3o): each of the port's tools
# (python -m hypermerge_tpu_torch.tools.<name>) through its `main(argv)`
# in this process or as a process of its own, on phase 3n's plain copy of
# phase 3d's corpus (2,048 docs x 1,024 ops, bench.py `_config_read`)
# before the script removes it: (a) `meta --stats` here, the launch counts
# set to 0 just before and read just after (pack_prefix and
# materialize_wire once a slab); (b) `meta --stats` as a process on the
# card (its counters: slab.h2d_bytes > 0); (c) `ls` (2,048 doc lines,
# the corpus's urls, scrub=ok wal=clean); (d) `cat` and `watch --once` of
# docs, each equal to bench_torch/reference.py's plain replay of the doc's
# stored changes; (e) `cp` of a seeded 1 MiB file in, `cat` of it out
# byte-equal, `meta` of its url (size, mime type); (f) `serve --ipc` as a
# process on the card (--port 0): 8 threads x 250 `len` Read queries over
# its socket, each equal to the replay, then `top --sock ... --once
# --json` (serve.reads > 0) and the daemon's maps (libcuda, the built
# serve_counts library), stopped with SIGINT (it closes its repo and
# swarm and exits 0); (g) `scrub --dry-run --json` on a copy of the
# corpus taken after (a)-(f) (the database copied, the feeds linked: a dry
# run writes no feed) with a seeded repo.dirty marker: the report parses
# and the marker's bytes are unchanged. A `tools` JSON line; 3o must
# finish within TOOLS["budget_s"].
TOOLS = dict(readers=8, reads=250, read_docs=64, cat_docs=(0, 1, 1023, 2047),
             file_bytes=1 << 20, file_seed=0x3F11E, budget_s=60.0,
             start_s=120.0)
TOOLS_MODULE = "hypermerge_tpu_torch.tools"


def replay_raw(corpus: str, url: str):
    """bench_torch/reference.py's plain replay of a doc's stored changes
    (Text as ["__text__", str], Counter as ["__counter__", int])."""
    from bench_torch.reference import replay_value, stored_changes
    from hypermerge_tpu_torch.utils.ids import validate_doc_url

    return replay_value(stored_changes(corpus, validate_doc_url(url)))


def replay_plain(corpus: str, url: str):
    """The replay of a doc as the tools print it (Text a str, Counter an
    int)."""
    def unplain(v):
        if isinstance(v, list) and len(v) == 2 and v[0] in (
                "__text__", "__counter__"):
            return v[1]
        if isinstance(v, dict):
            return {k: unplain(x) for k, x in v.items()}
        if isinstance(v, list):
            return [unplain(x) for x in v]
        return v

    return unplain(replay_raw(corpus, url))


def run_tool(name: str, argv: list, device=None) -> dict:
    """`tools.<name>.main(argv)` in this process, its stdout and stderr
    captured (stdout with a binary buffer: `cat` of a file writes bytes);
    HM_RECOVER is put back after it (the scrub tool sets it). Returns the
    exit code, the outputs and the wall."""
    import importlib
    import io

    mod = importlib.import_module(f"{TOOLS_MODULE}.{name}")
    argv = list(argv) + ([] if device is None else ["--device", str(device)])
    out = io.TextIOWrapper(io.BytesIO(), encoding="utf-8")
    err = io.StringIO()
    was = os.environ.get("HM_RECOVER")
    code = 0
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            mod.main(argv)
    except SystemExit as e:
        code = e.code if isinstance(e.code, int) else (0 if e.code is None
                                                       else 1)
    finally:
        wall = time.perf_counter() - t0
        if was is None:
            os.environ.pop("HM_RECOVER", None)
        else:
            os.environ["HM_RECOVER"] = was
    out.flush()
    raw = out.buffer.getvalue()
    return dict(code=code, raw=raw, out=raw.decode("utf-8", "replace"),
                err=err.getvalue(), wall_s=wall)


def tool_ok(label: str, r: dict) -> dict:
    if r["code"] != 0:
        raise AssertionError(f"phase 3o {label}: exit {r['code']}: "
                             f"{r['err'][-2000:]}")
    return r


def tool_process(argv: list, device=None, timeout: float = 120.0) -> dict:
    """`python -m hypermerge_tpu_torch.tools.<argv>` as a process of its
    own, from the repo's root."""
    here = os.path.dirname(os.path.abspath(__file__))
    cmd = [sys.executable, "-m", f"{TOOLS_MODULE}.{argv[0]}", *argv[1:]]
    if device is not None:
        cmd += ["--device", str(device)]
    t0 = time.perf_counter()
    p = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout,
                       cwd=here)
    return dict(code=p.returncode, out=p.stdout, err=p.stderr,
                wall_s=time.perf_counter() - t0)


def tools_serve(corpus: str, urls: list, device=None) -> dict:
    """Phase 3o (f): the serve daemon with its query socket, the `len`
    reads over it from TOOLS["readers"] threads, `top --sock`, its maps,
    and its stop on SIGINT."""
    import signal
    import socket as socketmod
    import threading

    from bench_torch.reference import query_value
    from hypermerge_tpu_torch import msgs
    from hypermerge_tpu_torch.kernels import _build
    from hypermerge_tpu_torch.net.tcp import TcpDuplex
    from hypermerge_tpu_torch.utils.ids import validate_doc_url

    here = os.path.dirname(os.path.abspath(__file__))
    sock_dir = tempfile.mkdtemp(prefix="hm-3o-")
    sock = os.path.join(sock_dir, "serve.sock")
    cmd = [sys.executable, "-m", f"{TOOLS_MODULE}.serve", corpus,
           "--port", "0", "--ipc", sock]
    if device is not None:
        cmd += ["--device", str(device)]
    query = {"kind": "len", "path": []}
    docs = urls[: TOOLS["read_docs"] // 2] + urls[
        len(urls) // 2: len(urls) // 2 + TOOLS["read_docs"] // 2]
    want = {u: query_value(replay_raw(corpus, u), query) for u in docs}
    t0 = time.perf_counter()
    daemon = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, cwd=here)
    lines: list = []
    try:
        threading.Thread(target=lambda: lines.extend(
            iter(daemon.stdout.readline, "")), daemon=True).start()
        wait_for("the serve daemon's announce",
                 lambda: any("serving" in ln for ln in lines)
                 or daemon.poll() is not None, TOOLS["start_s"], "3o")
        if daemon.poll() is not None:
            raise AssertionError(f"phase 3o (f): the daemon exited "
                                 f"{daemon.returncode}: "
                                 f"{daemon.stderr.read()[-2000:]}")
        t_up = time.perf_counter() - t0
        lat = []
        errs = []

        def reader(n):
            s = socketmod.socket(socketmod.AF_UNIX, socketmod.SOCK_STREAM)
            s.connect(sock)
            duplex = TcpDuplex(s, is_client=True)
            box = {}
            got = threading.Event()

            def on_msg(msg):
                if isinstance(msg, dict) and msg.get("type") == "Reply":
                    box["payload"] = msg.get("payload")
                    got.set()

            duplex.on_message(on_msg)
            try:
                for i in range(TOOLS["reads"]):
                    u = docs[(n * TOOLS["reads"] + i * 7) % len(docs)]
                    got.clear()
                    t = time.perf_counter()
                    duplex.send(msgs.query_msg(i, msgs.read_query(
                        validate_doc_url(u), query)))
                    if not got.wait(60):
                        raise AssertionError(f"phase 3o (f): no reply to "
                                             f"read {i} of reader {n}")
                    lat.append(time.perf_counter() - t)
                    if box["payload"] != {"value": want[u]}:
                        errs.append((u, box["payload"], want[u]))
            finally:
                duplex.close()

        read_s = run_threads(TOOLS["readers"], reader)
        if errs:
            raise AssertionError(f"phase 3o (f): {len(errs)} answers differ "
                                 f"from the replay: {errs[:3]}")
        topr = tool_ok("(f) top --sock", run_tool(
            "top", ["--sock", sock, "--once", "--json"]))
        tele = json.loads(topr["out"].strip().splitlines()[-1])
        reads = tele["counters"].get("serve.reads", 0)
        with open(f"/proc/{daemon.pid}/maps") as f:
            maps = f.read()
        lib = str(_build.target("serve_counts"))
        mapped = {"libcuda": "libcuda" in maps,
                  os.path.basename(lib): lib in maps}
        daemon.send_signal(signal.SIGINT)
        rc = daemon.wait(timeout=60)
    finally:
        if daemon.poll() is None:
            daemon.kill()
            daemon.wait(timeout=30)
        shutil.rmtree(sock_dir, ignore_errors=True)
    if reads <= 0:
        raise AssertionError(f"phase 3o (f): top --sock read serve.reads "
                             f"{reads}")
    if device is None and not all(mapped.values()):
        raise AssertionError(f"phase 3o (f): the daemon maps {mapped}")
    if rc != 0:
        raise AssertionError(f"phase 3o (f): the daemon exited {rc} on "
                             f"SIGINT: {daemon.stderr.read()[-2000:]}")
    return dict(code=rc, wall_s=time.perf_counter() - t0, up_s=t_up,
                reads=len(lat), read_s=read_s, qps=len(lat) / read_s,
                p50_ms=quantile_ms(lat, 0.50), p99_ms=quantile_ms(lat, 0.99),
                serve_reads=reads, serve_dispatches=tele["counters"].get(
                    "serve.dispatches", 0), maps=mapped, top_s=topr["wall_s"])


def tools_path(ck, corpus: str, urls: list, device=None) -> tuple:
    """Phase 3o: (a)-(g) on `corpus`. Returns ((a)'s launch counts, the
    numbers). `device="cpu"` is the CPU rehearsal: the tools run with
    `--device cpu`, the plain versions run and no launch is counted."""
    import random

    import torch

    from bench_torch.coldopen import fresh_copy
    from hypermerge_tpu_torch import native

    card = card_line() if device is None else str(device)
    t_phase = time.perf_counter()
    tools = {}

    # (a) meta --stats here, launches counted
    for k in ck.launches:
        ck.launches[k] = 0
    r = tool_ok("(a) meta --stats", run_tool(
        "meta", [corpus, "--stats"], device))
    if device is None:
        torch.cuda.synchronize()
    launches = {k: v for k, v in ck.launches.items() if v}
    slabs = math.ceil(len(urls) / 4096)
    if device is None and any(launches.get(k) != slabs for k in BULK):
        raise AssertionError(f"phase 3o (a): meta --stats launched "
                             f"{launches}, expected {slabs} of each of {BULK}")
    stats = json.loads(r["out"])
    tools["meta_stats"] = dict(code=r["code"], wall_s=r["wall_s"],
                               launches=launches,
                               slab_h2d_bytes=stats.get("slab.h2d_bytes"))

    # (b) meta --stats as a process on the card
    r = tool_ok("(b) meta --stats process", tool_process(
        ["meta", corpus, "--stats"], device))
    h2d = json.loads(r["out"].strip().splitlines()[-1]).get("slab.h2d_bytes",
                                                            0)
    if device is None and not h2d > 0:
        raise AssertionError(f"phase 3o (b): slab.h2d_bytes {h2d}")
    tools["meta_stats_process"] = dict(code=r["code"], wall_s=r["wall_s"],
                                       slab_h2d_bytes=h2d)

    # (c) ls: every doc, its url, its scrub verdict, wal=clean. Phase 3d
    # writes the corpus's signature records only where libsodium signs
    # them (not on the card's host): an unsigned feed's blocks all lie
    # beyond its last signature record, which ls reports as unsigned_tail
    signed = bool(native.caps() & native.CAP_SODIUM)
    verdict = "ok" if signed else "unsigned_tail"
    r = tool_ok("(c) ls", run_tool("ls", [corpus], device))
    lines = [ln for ln in r["out"].splitlines()
             if ln.startswith("hypermerge:/")]
    got = sorted(ln.split()[0] for ln in lines)
    bad = [ln for ln in lines if f" scrub={verdict} " not in ln
           or not ln.endswith(" wal=clean")]
    if got != sorted(urls) or bad:
        raise AssertionError(f"phase 3o (c): {len(lines)} doc lines "
                             f"({len(set(got) ^ set(urls))} urls differ), "
                             f"{len(bad)} not ok: {bad[:2]}")
    tools["ls"] = dict(code=r["code"], wall_s=r["wall_s"], docs=len(lines),
                       scrub=verdict)

    # (d) cat and watch --once of docs, each == the plain replay
    cat_w = watch_w = 0.0
    for i in TOOLS["cat_docs"]:
        u = urls[i % len(urls)]
        want = replay_plain(corpus, u)
        c = tool_ok("(d) cat", run_tool("cat", [corpus, u], device))
        w = tool_ok("(d) watch --once", run_tool(
            "watch", [corpus, u, "--once"], device))
        cat_w += c["wall_s"]
        watch_w += w["wall_s"]
        if json.loads(c["out"].strip().splitlines()[-1]) != want:
            raise AssertionError(f"phase 3o (d): cat of doc {i} != replay")
        if json.loads(w["out"].strip().splitlines()[-1]) != {
                "history": -1, "doc": want}:
            raise AssertionError(f"phase 3o (d): watch of doc {i} != replay")
    tools["cat"] = dict(code=0, wall_s=cat_w, docs=len(TOOLS["cat_docs"]))
    tools["watch"] = dict(code=0, wall_s=watch_w, docs=len(TOOLS["cat_docs"]))

    # (e) cp a seeded 1 MiB file in, cat it out, meta of its url
    data = random.Random(TOOLS["file_seed"]).randbytes(TOOLS["file_bytes"])
    with tempfile.TemporaryDirectory(prefix="hm-3o-") as tmp:
        src = os.path.join(tmp, "payload.bin")
        with open(src, "wb") as fh:
            fh.write(data)
        c = tool_ok("(e) cp", run_tool("cp", [corpus, src], device))
        file_url = c["out"].strip().splitlines()[-1]
        k = tool_ok("(e) cat of the file", run_tool(
            "cat", [corpus, file_url], device))
        m = tool_ok("(e) meta of the file", run_tool(
            "meta", [corpus, file_url], device))
    fmeta = json.loads(m["out"].strip().splitlines()[-1])
    if not file_url.startswith("hyperfile:/") or k["raw"] != data:
        raise AssertionError(f"phase 3o (e): {file_url!r}: cat gave "
                             f"{len(k['raw'])} bytes, not the file's "
                             f"{len(data)}")
    if fmeta != {"type": "File", "bytes": len(data),
                 "mimeType": "application/octet-stream"}:
        raise AssertionError(f"phase 3o (e): meta of the file {fmeta}")
    tools["cp"] = dict(code=c["code"], wall_s=c["wall_s"], bytes=len(data))
    tools["cat_file"] = dict(code=k["code"], wall_s=k["wall_s"])
    tools["meta_file"] = dict(code=m["code"], wall_s=m["wall_s"])

    # (f) serve --ipc as a process on the card
    tools["serve"] = tools_serve(corpus, urls, device)

    # (g) scrub --dry-run --json on a copy with a crash marker
    marker = random.Random(TOOLS["file_seed"] + 1).randbytes(64)
    with tempfile.TemporaryDirectory(prefix="hm-3o-") as tmp:
        copy = os.path.join(tmp, "repo")
        t0 = time.perf_counter()
        fresh_copy(corpus, copy)
        t_copy = time.perf_counter() - t0
        with open(os.path.join(copy, "repo.dirty"), "wb") as fh:
            fh.write(marker)
        s = tool_ok("(g) scrub --dry-run", run_tool(
            "scrub", [copy, "--dry-run", "--json"], device))
        report = json.loads(s["out"].strip().splitlines()[-1])
        with open(os.path.join(copy, "repo.dirty"), "rb") as fh:
            kept = fh.read() == marker
    if not kept or report.get("feeds", 0) < len(urls):
        raise AssertionError(f"phase 3o (g): marker kept {kept}, report "
                             f"{ {k: report.get(k) for k in ('feeds', 'bytes_truncated')} }")
    tools["scrub"] = dict(code=s["code"], wall_s=s["wall_s"], copy_s=t_copy,
                          feeds=report["feeds"],
                          t_recover_ms=report.get("t_recover_ms"),
                          repaired=report["bytes_truncated"])

    wall = time.perf_counter() - t_phase
    numbers = dict(card=card, wall_s=wall, docs=len(urls), tools=tools)
    log("tools " + json.dumps(numbers))
    log(f"phase 3o check: meta --stats launched {launches} here and moved "
        f"{h2d} bytes to the card in its own process; ls listed "
        f"{len(lines)} docs, scrub={verdict} wal=clean; cat and watch of "
        f"{len(TOOLS['cat_docs'])} docs == the replay; a "
        f"{len(data)}-byte file cp'd in and cat'd out byte-equal; serve "
        f"--ipc answered {tools['serve']['reads']} len reads == the replay "
        f"({tools['serve']['qps']:.0f}/s), serve.reads "
        f"{tools['serve']['serve_reads']}, maps {tools['serve']['maps']}; "
        f"scrub --dry-run over {report['feeds']} feeds kept the marker; "
        f"phase wall {wall:.1f} s [{card}]")
    if wall > TOOLS["budget_s"]:
        raise AssertionError(f"phase 3o took {wall:.1f} s, over its "
                             f"{TOOLS['budget_s']} s")
    return launches, numbers


def tools_main() -> int:
    """`--tools`: phase 3o alone on the card (phase 3d's corpus written
    first, the kernels built)."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from hypermerge_tpu_torch import native
    from hypermerge_tpu_torch.kernels import _build
    from hypermerge_tpu_torch.ops import crdt_kernels as ck
    from hypermerge_tpu_torch.ops.corpus import make_corpus

    log(card_line())
    _build.build()
    with tempfile.TemporaryDirectory(prefix="hm-read-") as root:
        sign = bool(native.caps() & native.CAP_SODIUM)
        corpus = os.path.join(root, "corpus")
        urls = make_corpus(corpus, READ["n_docs"], READ["n_ops"], sign=sign)
        tools_path(ck, corpus, urls)
    return 0


# ---------------------------------------------------------------------------
# phase 3p: the main path's reference cases on the card

TWINS = dict(fuzz_seeds=(1, 2, 3, 4, 5), pipeline_docs=14, pipeline_slab=4,
             mesh_shapes=((8, 1), (4, 2), (2, 2), (1, 1)),
             clock_shapes=((13, 5), (32, 16), (7, 11), (1, 1), (64, 3)),
             live_max_bytes="40000", budget_s=45.0)
# one peer change of this many ops closes (f)'s script
TWIN_PASTE = 16
# the live tick on the kernel at every size (3i's kernel env)
TWIN_LIVE_ENV = dict(HM_LIVE_INC_BUDGET="0", HM_DEVICE_MIN_CELLS="0",
                     HM_LIVE_MAX_BYTES=TWINS["live_max_bytes"])


class TwinSite:
    """tests/helpers.py's Site on the port's frontend and OpSet."""

    def __init__(self, actor):
        from hypermerge_tpu_torch.crdt.frontend_state import FrontendDoc
        from hypermerge_tpu_torch.crdt.opset import OpSet

        self.actor = actor
        self.front = FrontendDoc()
        self.opset = OpSet()
        self.seq = 1

    def change(self, fn):
        req, preview = self.front.change(fn, self.actor, self.seq, "")
        if req is None:
            return None, preview
        self.seq += 1
        change, patch = self.opset.apply_local_request(req)
        self.front.apply_patch(patch)
        return change, preview

    def receive(self, changes):
        self.front.apply_patch(self.opset.apply_changes(changes))

    @property
    def doc(self):
        return self.front.materialize()


def twin_sync(*sites):
    for a in sites:
        for b in sites:
            if a is not b:
                a.receive(list(b.opset.history))


def twin_mutation(site, r):
    """tests/helpers.py's random_mutation on the port's models."""
    from hypermerge_tpu_torch.models import Counter, Text

    def fn(d):
        choice = r.random()
        if choice < 0.3:
            d[r.choice("abc")] = r.randint(0, 99)
        elif choice < 0.45:
            if "l" not in d:
                d["l"] = []
            lst = d["l"]
            lst.insert(r.randint(0, len(lst)), r.randint(0, 9))
        elif choice < 0.55:
            if "l" in d and len(d["l"]) > 0:
                del d["l"][r.randint(0, len(d["l"]) - 1)]
        elif choice < 0.7:
            if "t" not in d:
                d["t"] = Text("")
            d["t"].insert(r.randint(0, len(d["t"])), r.choice("xyz"))
        elif choice < 0.8:
            if "n" not in d or not isinstance(d.get("n"), Counter):
                d["n"] = Counter(0)
            else:
                d.increment("n", r.randint(1, 3))
        elif choice < 0.9:
            k = r.choice("abc")
            if k in d:
                del d[k]
        else:
            d[r.choice("mn")] = {"v": [r.randint(0, 9)]}

    site.change(fn)


def twin_fuzz_history(seed):
    """test_device_materialize.py's test_fuzz_device_equals_host history:
    three sites, five rounds, partial gossip, then a full sync; returns
    (site 0, its history)."""
    import random

    r = random.Random(seed)
    sites = [TwinSite(a) for a in ("alice", "bob", "carol")]
    for _ in range(5):
        for s in sites:
            for _ in range(r.randint(1, 3)):
                twin_mutation(s, r)
        if r.random() < 0.6:
            donor, receiver = r.sample(sites, 2)
            receiver.receive(list(donor.opset.history))
    twin_sync(*sites)
    if plain_value(sites[0].doc) != plain_value(sites[1].doc):
        raise AssertionError(f"phase 3p (a) seed {seed}: sites diverged")
    return sites[0], list(sites[0].opset.history)


def twin_causal_history():
    """test_causal_sort_is_valid_linear_extension's history, shuffled
    with Random(0), and the causal order's check."""
    import random

    from hypermerge_tpu_torch.ops import columnar

    a, b = TwinSite("alice"), TwinSite("bob")
    a.change(lambda d: d.__setitem__("x", 1))
    b.receive(a.opset.history)
    b.change(lambda d: d.__setitem__("y", 2))
    a.receive(b.opset.history)
    a.change(lambda d: d.__setitem__("z", 3))
    shuffled = list(a.opset.history)
    random.Random(0).shuffle(shuffled)
    seen = {}
    for c in columnar.causal_sort(shuffled):
        if any(seen.get(x, 0) < s for x, s in c.deps.items()) or \
                seen.get(c.actor, 0) != c.seq - 1:
            raise AssertionError("phase 3p (a): causal_sort is not a "
                                 "linear extension")
        seen[c.actor] = c.seq
    return a, shuffled


def twin_doc_routes(ck, batch, label, dev):
    """One batch through doc_kernel.cu on both routes — the many-block
    route (kernel 1 alone) and the one-block slab launch with the
    summary_wire.cuh epilogue — each lane held to run_batch_host and to
    the plain version, the wire to summarize_wire_plain; tolerance 0.
    Returns the one-block route's lanes (on the card)."""
    import numpy as np
    import torch

    from hypermerge_tpu_torch.ops.host_kernel import run_batch_host

    host = run_batch_host(batch)
    plain = ck.run_batch(batch, device="cpu")
    N = batch.n_rows
    _da, A, _K = ck.bucket_doc_actors(batch)
    plain_wire = ck.summarize_wire_plain(plain, N, A, lean=False)
    if dev.type == "cpu":  # the rehearsal: the plain version stands in
        outs, wire = [("plain", plain)], plain_wire
    else:
        args, A, K = ck.device_args(batch, device=dev)
        many = ck.materialize_cuda(*args, A=A, K=K,
                                   route=ck.DOC_ROUTE_MANY_BLOCK)
        one, wire = ck.materialize_wire_cuda(*args, A=A, K=K, lean=False,
                                             route=ck.DOC_ROUTE_ONE_BLOCK)
        outs = [("many-block", many), ("one-block", one)]
        torch.cuda.synchronize()
    for route, out in outs:
        for f in host._fields:
            got = getattr(out, f).cpu().numpy()
            if not (np.array_equal(got, getattr(host, f))
                    and np.array_equal(got, getattr(plain, f).numpy())):
                raise AssertionError(f"phase 3p (a) {label} {route}: lane "
                                     f"{f} != host kernel / plain")
    if not torch.equal(wire.cpu(), plain_wire):
        raise AssertionError(f"phase 3p (a) {label}: wire != plain")
    return outs[-1][1]


def twins_materialize(ck, dev):
    """(a): test_device_materialize.py's fuzz seeds, its host-kernel case
    and its causal-sort case through doc_kernel.cu's two routes."""
    from hypermerge_tpu_torch.ops import columnar
    from hypermerge_tpu_torch.ops.materialize import (
        DecodedBatch,
        materialize_docs,
    )
    from hypermerge_tpu_torch.ops.synth import synth_batch, synth_changes

    cases = []
    for seed in TWINS["fuzz_seeds"]:
        site, hist = twin_fuzz_history(seed)
        cases.append((f"fuzz seed {seed}", site, [hist]))
    site, shuffled = twin_causal_history()
    cases.append(("causal sort", site, [columnar.causal_sort(shuffled)]))
    n_docs = 0
    for label, site, hists in cases:
        batch = columnar.pack_docs(hists)
        out = twin_doc_routes(ck, batch, label, dev)
        doc = materialize_docs(DecodedBatch(batch, out))[0]
        if plain_value(doc) != plain_value(site.opset.materialize()):
            raise AssertionError(f"phase 3p (a) {label}: the card's doc != "
                                 "the host OpSet's")
        n_docs += batch.n_docs
    for label, batch in (
            ("host kernel pack_docs", columnar.pack_docs(
                [synth_changes(257, seed=s) for s in range(3)])),
            ("host kernel synth_batch", synth_batch(5, 192))):
        twin_doc_routes(ck, batch, label, dev)
        n_docs += batch.n_docs
    return {"batches": len(cases) + 2, "docs": n_docs}


def twins_wire(ck, dev):
    """(b): test_summary_wire.py's test_wire_matches_host_reference_summary
    through summary_wire.cu, full and lean, and the slab's one launch."""
    import numpy as np
    import torch

    from hypermerge_tpu_torch.ops.columnar import pack_docs
    from hypermerge_tpu_torch.ops.materialize import (
        DecodedBatch,
        decode_columnar,
        fetch_summary,
    )
    from hypermerge_tpu_torch.ops.synth import synth_changes

    batch = pack_docs([synth_changes(96, n_actors=3, ops_per_change=8,
                                     seed=s) for s in range(4)])
    plain = ck.run_batch(batch, device="cpu")
    want = decode_columnar(DecodedBatch(batch, plain))
    N = batch.n_rows
    _da, A, _K = ck.bucket_doc_actors(batch)
    out = ck.run_batch(batch, device=dev)
    for lean in (False, True):
        plain_wire = ck.summarize_wire_plain(plain, N, A, lean)
        wire = ck.summarize_wire(out, N, A, lean)
        if not torch.equal(wire.cpu(), plain_wire):
            raise AssertionError(f"phase 3p (b): wire (lean={lean}) != plain")
        got = fetch_summary(wire, batch, lean=lean)
        keys = ["map_winner", "elem_live", "elem_order", "n_live_elems",
                "n_map_entries"] + ([] if lean else ["clock"])
        for k in keys:
            if not np.array_equal(np.asarray(got[k]), np.asarray(want[k])):
                raise AssertionError(f"phase 3p (b): {k} (lean={lean}) != "
                                     "decode_columnar")
    fused = ck.run_batch_summary(batch, device=dev)
    if not torch.equal(fused.cpu(), ck.summarize_wire_plain(plain, N, A,
                                                            False)):
        raise AssertionError("phase 3p (b): the slab launch's wire != plain")
    return {"shape": [batch.n_docs, N], "A": A}


def twins_clocks(dev):
    """(c): test_clock.py's four infinity cases and test_clock_mirror.py's
    test_infinity_clamps on the card, each held to the plain version."""
    import math

    import torch

    from hypermerge_tpu_torch.crdt import clock as C
    from hypermerge_tpu_torch.ops import clock_kernels as K
    from hypermerge_tpu_torch.ops.clock_mirror import DeviceClockMirror

    inf = int(K.INT32_INF)
    rows = K.pack_clocks(C.pack([{"a": C.INFINITY_SEQ}], ["a"]), device=dev)
    if int(rows[0, 0]) != inf:
        raise AssertionError("phase 3p (c): INFINITY_SEQ not clamped")
    if C.pack([{"a": math.inf, "b": 2}], ["a", "b"]) != [[C.INFINITY_SEQ, 2]]:
        raise AssertionError("phase 3p (c): math.inf not packed")
    m = [[inf, inf], [1, 1], [9, 9]]
    got = K.top_k_dominated(K.pack_clocks(m, device=dev),
                            K.pack_clocks([m[0]], device=dev)[0], 3)
    want = K.top_k_dominated(K.pack_clocks(m, device="cpu"),
                             K.pack_clocks([m[0]], device="cpu")[0], 3)
    if int(got[1][0]) != 0 or int(got[0][0]) <= 0 or not all(
            torch.equal(g.cpu(), w) for g, w in zip(got, want)):
        raise AssertionError("phase 3p (c): top-k with inf entries")
    a = {"x": math.inf}
    b = C.strs_to_clock(C.clock_to_strs(a))
    if b != {"x": C.INFINITY_SEQ} or C.cmp(a, b) is not C.Ordering.EQ:
        raise AssertionError("phase 3p (c): inf != INFINITY_SEQ on the host")
    pa = K.pack_clocks(C.pack([a], ["x"]), device=dev)
    pb = K.pack_clocks(C.pack([b], ["x"]), device=dev)
    if int(K.cmp(pa, pb)[0]) != K.EQ or not bool(K.gte(pa[0], pb)[0]):
        raise AssertionError("phase 3p (c): inf rows do not compare equal")
    answers = []
    for d in (dev, torch.device("cpu")):
        mirror = DeviceClockMirror(capacity_docs=2, capacity_actors=2,
                                   device=d)
        mirror.update("d", {"a": 2**60})
        answers.append((mirror.rows(), mirror.union(),
                        mirror.dominated({"a": 2**62}),
                        mirror.top_k_dominated({"a": 2**62}, k=1)))
    if answers[0] != answers[1] or answers[0][0]["d"]["a"] != inf:
        raise AssertionError(f"phase 3p (c): the mirror {answers}")
    return {"mirror": repr(answers[0])}


def twin_corpus(path, n_docs, seed, device):
    """test_pipeline.py's _make_corpus and _add_gap_doc, written by a
    port Repo: single-writer docs of maps, text and counters, then a doc
    whose feed skips a seq. Returns the urls, the gap doc last."""
    import random

    from hypermerge_tpu_torch.crdt.change import ROOT, Action, Change, Op
    from hypermerge_tpu_torch.models import Counter, Text
    from hypermerge_tpu_torch.repo import Repo
    from hypermerge_tpu_torch.storage import block as blockmod
    from hypermerge_tpu_torch.utils.ids import validate_doc_url

    r = random.Random(seed)
    repo = Repo(path=str(path), device=device)
    try:
        urls = []
        for i in range(n_docs):
            u = repo.create({"i": i, "t": Text(f"doc{i}:"),
                             "hits": Counter(0)})
            for k in range(r.randrange(1, 9)):
                kind = r.randrange(3)
                if kind == 0:
                    repo.change(u, lambda d, k=k: d.__setitem__(f"k{k}",
                                                                 k * 3))
                elif kind == 1:
                    repo.change(u, lambda d, k=k: d["t"].insert(0, f"<{k}>"))
                else:
                    repo.change(u, lambda d: d.increment("hits", 2))
            urls.append(u)
        gap = repo.create({"gap": True})
        doc_id = validate_doc_url(gap)
        actor = repo.back.actors[doc_id]
        head = actor.seq_head
        max_op = max(c.max_op for c in actor.changes_in_window(0, INF))
        actor.feed._append_raw(blockmod.pack(Change(
            actor=doc_id, seq=head + 2, start_op=max_op + 1, deps={},
            ops=(Op(action=Action.SET, obj=ROOT, key="late", value=1),),
        ).to_json()))
    finally:
        repo.close()
    return urls + [gap]


def twin_summary_bytes(summ, doc_id):
    arrays, j = summ.arrays(doc_id)
    out = {k: arrays[k][j].tobytes()
           for k in ("map_winner", "elem_live", "elem_order")}
    out["n_live"] = int(arrays["n_live_elems"][j])
    out["n_map"] = int(arrays["n_map_entries"][j])
    out["clock"] = summ.doc(doc_id)["clock"]
    return out


def twin_load_twice(path, ids, slab, device):
    """test_pipeline.py's _load_twice: two bulk loads in one backend (the
    second all memo hits): summaries of each, the memo, the counts."""
    from hypermerge_tpu_torch.repo import Repo

    repo = Repo(path=str(path), device=device)
    try:
        back = repo.back
        back.load_documents_bulk(ids, slab=slab)
        st1 = dict(back.last_bulk_stats)
        s1 = back.fetch_bulk_summaries()
        first = {d: twin_summary_bytes(s1, d) for d in s1.doc_ids}
        memo = {d: {k: (v.tobytes() if hasattr(v, "tobytes") else v)
                    for k, v in m.items()}
                for d, m in back._summary_memo.items()}
        for d in ids:
            back.close_doc(d)
        back.load_documents_bulk(ids, slab=slab)
        st2 = dict(back.last_bulk_stats)
        s2 = back.fetch_bulk_summaries()
        second = {d: twin_summary_bytes(s2, d) for d in s2.doc_ids}
    finally:
        repo.close()
    counts = [{k: st[k] for k in ("docs", "fast", "memo", "fallback")}
              for st in (st1, st2)]
    return first, second, memo, counts


def twins_pipeline(root, device):
    """(d): test_pipeline.py's test_pipeline_serial_equivalence_fuzz as
    card Repos: HM_PIPELINE=0 and =1 on copies of one corpus."""
    from hypermerge_tpu_torch.utils.ids import validate_doc_url

    src = os.path.join(root, "pipe-src")
    urls = twin_corpus(src, TWINS["pipeline_docs"], 7, device)
    ids = [validate_doc_url(u) for u in urls]
    results = {}
    for mode in ("0", "1"):
        copy = os.path.join(root, f"pipe{mode}")
        shutil.copytree(src, copy)
        with env_vars(HM_PIPELINE=mode, HM_DEVICE_MIN_CELLS="1"):
            results[mode] = twin_load_twice(copy, ids, TWINS["pipeline_slab"],
                                            device)
    (f0, s0, m0, c0), (f1, s1, m1, c1) = results["0"], results["1"]
    if c0 != c1 or c0[0]["fallback"] != 1 or c0[1]["memo"] != c0[1]["fast"]:
        raise AssertionError(f"phase 3p (d): counts {c0} vs {c1}")
    if len(f0) != TWINS["pipeline_docs"] or f0 != f1 or s0 != s1 or m0 != m1:
        raise AssertionError("phase 3p (d): pipelined != serial summaries")
    return {"docs": len(ids), "counts": c1[0]}


def protocol_rings(ringmod, mesh):
    """Install the flagged launch over virtual ranks ("protocol") as the
    ring of every group of 2 or more ranks the mesh's folds use."""
    groups = [mesh.dp_group(j) for j in range(mesh.shape["sp"])]
    groups += [mesh.sp_group(i) for i in range(mesh.shape["dp"])]
    for g in groups:
        if len(g) > 1:
            mesh._rings[tuple(g)] = ringmod.Ring(
                [mesh.devices[r] for r in g], "protocol")


def twins_mesh(dev):
    """(e): test_parallel.py's test_mesh_reductions_fuzz_bit_identical_
    across_shapes on virtual ranks of one card, the folds' rings in the
    flagged launch's protocol mode."""
    import numpy as np

    from hypermerge_tpu_torch.parallel import mesh as meshmod
    from hypermerge_tpu_torch.parallel import ring as ringmod
    from hypermerge_tpu_torch.parallel import sharded

    rng = np.random.default_rng(7)
    for dp, sp in TWINS["mesh_shapes"]:
        n = dp * sp
        mesh = meshmod.make_mesh(n, sp=sp, devices=[dev] * n)
        if dev.type == "cuda":
            protocol_rings(ringmod, mesh)
        for D, A in TWINS["clock_shapes"]:
            clocks = rng.integers(0, 1000, (D, A)).astype(np.int32)
            union = sharded.sharded_clock_union(clocks, mesh).numpy()
            query = clocks[rng.integers(0, D)]
            dom = sharded.sharded_dominated(clocks, query, mesh).numpy()
            if not (np.array_equal(union, clocks.max(axis=0)) and
                    np.array_equal(dom, np.all(clocks <= query, axis=-1))):
                raise AssertionError(f"phase 3p (e): {dp}x{sp} {D}x{A} "
                                     "!= numpy")
    return {"shapes": [list(s) for s in TWINS["mesh_shapes"]]}


def twin_stored_changes(repo, doc_id):
    out = []
    for actor_id, end in repo.back.docs[doc_id].clock.items():
        out.extend(repo.back._get_or_create_actor(actor_id)
                   .changes_in_window(0, end))
    return out


def twin_script(stored, pair_ids, seed, n_rounds=8):
    """test_live_demote.py's _gen_script: deterministic two-peer batches
    extending `stored`, the peers keyed by real feed keypairs; returns
    (the batches, the peers)."""
    import random

    r = random.Random(seed)
    peers = [TwinSite(a) for a in pair_ids]
    for p in peers:
        p.receive(stored)
    script = []
    for rnd in range(n_rounds):
        idx = r.randrange(2)
        site = peers[idx]
        batch = []
        for _ in range(r.randint(1, 3)):
            before = len(site.opset.history)
            twin_mutation(site, r)
            batch.extend(site.opset.history[before:])
        if batch:
            script.append((idx, batch))
        if rnd % 3 == 2:
            twin_sync(*peers)
    return script, peers


def twin_demote_seed(base, device):
    """test_live_demote.py's _seed: a doc of five edits and two peer
    keypairs, written under HM_LIVE=0."""
    from hypermerge_tpu_torch.repo import Repo
    from hypermerge_tpu_torch.utils import keys as keymod
    from hypermerge_tpu_torch.utils.ids import validate_doc_url

    with env_vars(HM_LIVE="0"):
        repo = Repo(path=base, device=device)
        try:
            url = repo.create({"edits": [], "k": 0})
            for i in range(5):
                repo.change(url, lambda d, i=i: d["edits"].append(i))
        finally:
            repo.close()
    pairs = [keymod.create() for _ in range(2)]
    return {"url": url, "doc_id": validate_doc_url(url),
            "pairs": [[p.public_key, p.secret_key] for p in pairs]}


def twin_demote_run(base, meta, live, order_flip, device, seed=23):
    """test_live_demote.py's _run_demote_workload under HM_LIVE=`live` on
    a copy of `base`: feed-backed peer deliveries, a local edit after
    each, every idle doc demoted between deliveries; returns the outcome
    (snapshot, clock, history length, state, local patch echoes) as JSON
    with the local actor id scrubbed."""
    from hypermerge_tpu_torch.crdt.opset import OpSet
    from hypermerge_tpu_torch.repo import Repo
    from hypermerge_tpu_torch.utils import keys as keymod

    work = tempfile.mkdtemp(prefix="hm-demote-")
    shutil.rmtree(work)
    shutil.copytree(base, work)
    try:
        with env_vars(HM_LIVE=live):
            repo = Repo(path=work, device=device)
            try:
                url, doc_id = meta["url"], meta["doc_id"]
                local_patches = []
                orig_push = repo.back.to_frontend.push

                def record(msg):
                    if msg.get("type") == "Patch" and msg["patch"].get(
                            "actor"):
                        local_patches.append(msg["patch"])
                    orig_push(msg)

                repo.back.to_frontend.push = record
                h = repo.open(url)
                if h.value(timeout=20) is None:
                    raise AssertionError("phase 3p (f): the doc never opened")
                back = repo.back
                doc = back.docs[doc_id]
                stored = twin_stored_changes(repo, doc_id)
                script, peers = twin_script(
                    stored, [pk for pk, _ in meta["pairs"]], seed)
                if order_flip:
                    script = ([b for b in script if b[0] == 1]
                              + [b for b in script if b[0] == 0])
                # then one paste of TWIN_PASTE ops by peer 0 (3i (a)'s
                # paste): the case's deliveries are 1-3 one-op changes,
                # and a tick of 8 ops or fewer always applies
                # incrementally, so this is the delivery whose tick
                # takes the kernel
                twin_sync(*peers)
                paste, _ = peers[0].change(lambda d: [
                    d.__setitem__(f"p{i}", i) for i in range(TWIN_PASTE)])
                script.append((0, [paste]))
                actors = [back._init_actor(keymod.KeyPair(pk, sk))
                          for pk, sk in meta["pairs"]]
                for a in actors:
                    back.cursors.add_actor(back.id, doc_id, a.id)
                oracle = OpSet()
                oracle.apply_changes(stored)
                peer_actors = set()
                for k, (idx, batch) in enumerate(script):
                    oracle.apply_changes(list(batch))
                    peer_actors.update(c.actor for c in batch)
                    for ch in batch:
                        actors[idx].write_change(ch)
                    back.cursors.update(back.id, doc_id,
                                        {actors[idx].id: batch[-1].seq})
                    back._sync_changes(actors[idx])
                    wait_for("3p (f) delivery", lambda: all(
                        doc.clock.get(a, 0) == oracle.clock.get(a, 0)
                        for a in peer_actors), 30, phase="3p")
                    repo.change(url, lambda d, k=k: d.__setitem__(f"k{k}", k))
                    if back.live is not None:
                        back.live.flush_now()
                        back.live.demote_idle(0)
                if back.live is not None:
                    back.live.flush_now()
                    back.live.demote_idle(0)
                repo.change(url, lambda d: d.__setitem__("fin", 1))
                stats = {}
                if back.live is not None:
                    back.live.flush_now()
                    stats = dict(back.live.stats)
                    if not (stats["demoted"] > 0 and stats["readopted"] > 0):
                        raise AssertionError(f"phase 3p (f): {stats}")
                outcome = {
                    "snap": doc.snapshot_patch().to_json(),
                    "clock": dict(doc.clock),
                    "hist": doc.history_len,
                    "state": plain_value(h.value()),
                    "local_patches": local_patches,
                }
                actor_id = doc.actor_id
            finally:
                repo.close()
    finally:
        shutil.rmtree(work, ignore_errors=True)

    def scrub(v):
        if isinstance(v, str):
            return v.replace(actor_id, "<LOCAL-ACTOR>")
        if isinstance(v, dict):
            return {scrub(k): scrub(x) for k, x in v.items()}
        if isinstance(v, (list, tuple)):
            return [scrub(x) for x in v]
        return v

    return json.dumps(scrub(outcome), sort_keys=True, default=str), stats


def twins_demote(root, device):
    """(f): test_live_demote.py's test_demote_readopt_twin_bit_identical
    on a card Repo under HM_LIVE_MAX_BYTES, the live tick on the kernel
    (3i's kernel env), both delivery orders, against HM_LIVE=0."""
    base = os.path.join(root, "demote-seed")
    os.makedirs(base)
    meta = twin_demote_seed(base, device)
    out = {}
    with env_vars(**TWIN_LIVE_ENV):
        for flip in (False, True):
            host, _ = twin_demote_run(base, meta, "0", flip, device)
            live, stats = twin_demote_run(base, meta, "1", flip, device)
            if live != host:
                raise AssertionError(f"phase 3p (f) flip={flip}: HM_LIVE=1 "
                                     "!= HM_LIVE=0")
            out["rev" if flip else "fwd"] = {
                k: stats.get(k) for k in ("demoted", "readopted",
                                          "device_dispatches")}
    return out


TWIN_PARTS = {
    "a": ("materialize", "materialize_wire"),
    "b": ("summary_wire",),
    "c": CLOCKS,
    "d": BULK,
    "e": MESH,
    "f": ("materialize_live",),
}


def twins_path(ck, device=None) -> tuple:
    """Phase 3p: (a)-(f). Returns (the launches summed over the parts,
    the numbers). Each part sets the launch counts to 0 just before and
    reads them just after; a part whose kernels did not launch fails.
    `device="cpu"` is the CPU rehearsal: the plain versions run and no
    launch is counted."""
    import torch

    dev = torch.device("cuda" if device is None else device)
    t_phase = time.perf_counter()
    parts = {
        "a": lambda: twins_materialize(ck, dev),
        "b": lambda: twins_wire(ck, dev),
        "c": lambda: twins_clocks(dev),
        "e": lambda: twins_mesh(dev),
    }
    numbers, total = {}, dict.fromkeys(ck.launches, 0)
    with tempfile.TemporaryDirectory(prefix="hm-twins-") as root:
        parts["d"] = lambda: twins_pipeline(root, device)
        parts["f"] = lambda: twins_demote(root, device)
        for name in sorted(parts):
            for k in ck.launches:
                ck.launches[k] = 0
            t0 = time.perf_counter()
            got = parts[name]()
            if dev.type == "cuda":
                torch.cuda.synchronize()
            launches = {k: v for k, v in ck.launches.items() if v}
            missing = [k for k in TWIN_PARTS[name] if not launches.get(k)]
            if dev.type == "cuda" and missing:
                raise AssertionError(f"phase 3p ({name}): no launch of "
                                     f"{missing}: {launches}")
            for k, v in launches.items():
                total[k] += v
            numbers[name] = dict(got, launches=launches,
                                 wall_s=time.perf_counter() - t0)
    numbers["wall_s"] = time.perf_counter() - t_phase
    if dev.type == "cuda" and numbers["wall_s"] > TWINS["budget_s"]:
        raise AssertionError(f"phase 3p took {numbers['wall_s']:.1f} s, over "
                             f"its {TWINS['budget_s']} s")
    log("twins " + json.dumps(numbers))
    return {k: v for k, v in total.items() if v}, numbers


def twins_main() -> int:
    """`--twins`: phase 3p alone on the card (the kernels built first)."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from hypermerge_tpu_torch.kernels import _build
    from hypermerge_tpu_torch.ops import crdt_kernels as ck

    log(card_line())
    _build.build()
    twins_path(ck)
    return 0


def doc_entry_call(ck, args, A, K):
    """A call of doc_kernel.cu's entry alone (route picked from (D, N), no
    wrapper, no allocation) on copies of the live tick's arguments and
    outputs and scratch of its own, for cold_calls_ms."""
    import torch

    flags, slot, ctr, obj, key, ref, value, psrc, ptgt = args
    D, N = flags.shape
    dev = flags.device
    fl = flags.clone()
    # slot, ctr, seq (absent), obj .. ptgt at the widths the link gives them
    lanes = [t.clone() for t in (slot, ctr)] + [None] + [
        t.clone() for t in (obj, key, ref, value, ptgt)]
    widths = sum((4 if t is None else t.element_size()) << (4 * k)
                 for k, t in enumerate(lanes))
    b, i32 = torch.bool, torch.int32
    out = ([torch.empty(D, N, dtype=b, device=dev) for _ in range(5)]
           + [torch.empty(D, N, dtype=i32, device=dev) for _ in range(2)]
           + [torch.empty(D, A, dtype=i32, device=dev)])
    scratch = torch.empty(D, ck._DOC_SCRATCH_LANES, N + 2, dtype=i32,
                          device=dev)
    keys = torch.empty(D, N, dtype=torch.int64, device=dev)
    fn = ck.kernel_fn("doc_kernel")
    stream = ck.launch_stream(dev)
    ptrs = [None if t is None else t.data_ptr() for t in lanes]

    def call():
        if fn(fl.data_ptr(), *ptrs, widths, D, N, ptgt.shape[1], A, K,
              ck.DOC_ROUTE_AUTO, *(t.data_ptr() for t in out),
              scratch.data_ptr(), keys.data_ptr(), None, 0, 0, 0, 0, 0, 0,
              stream):
            raise AssertionError("doc_kernel alone failed to launch")
        return fl, lanes, out, scratch, keys
    return call


def time_live_kernel(ck, live, inputs):
    """Phase 4 for the live slice: materialize_live_device at [1, 262144]
    and [8, 32768] — the wrapper (CUDA events) and its host work, the
    kernels alone (the profiler, summed over every kernel the dispatch
    launches: doc_kernel.cu's many-block route, with their count), the
    entry alone cold (CUDA events over calls on memory of their own), the
    one-block route forced on the same inputs (CUDA events around the
    wrapper: its one launch of 5-60 ms is nearly the whole of it, and a
    profiler window of a few such calls can lose their records), the
    plain version on the card, the engine's numpy twin (`_host_lanes`,
    one doc at a time, host clock) on the same docs, and the bound."""
    import torch

    res = {}
    for label, (lvs, args, A, K) in inputs.items():
        flags, slot, ctr, obj, key, ref, value, psrc, ptgt = args
        D, N = flags.shape
        out = ck.materialize_live_device(*args, A=A, K=K)
        rounds = max(1, math.ceil(math.log2(max(N, 2)))) + 1
        log2n = max(1, int(math.log2(N)))
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            for lv in lvs:
                live.LiveApplyEngine._host_lanes(lv)
            times.append((time.perf_counter() - t0) * 1e3)
        kernel_ms, per_call = kernels_device_ms(
            lambda: ck.materialize_live_device(*args, A=A, K=K), DOC_KERNELS)
        one_block = doc_route_call(ck, args, A, K, ck.DOC_ROUTE_ONE_BLOCK)
        r = dict(
            D=D, N=N, A=A, K=K,
            ms=median_ms(lambda: ck.materialize_live_device(*args, A=A, K=K)),
            host_ms=host_call_ms(
                lambda: ck.materialize_live_device(*args, A=A, K=K), runs=20),
            kernel_ms=kernel_ms, kernels_per_call=per_call,
            cold_kernel_ms=cold_calls_ms(
                lambda _i: doc_entry_call(ck, args, A, K), count=8,
                slack=20 * COLD_SLACK_CYCLES),
            one_block_ms=median_ms(one_block, runs=3, warmup=1),
            plain_ms=median_ms(lambda: live_plain(ck, args, A, K)),
            numpy_twin_ms=statistics.median(times),
            library_ms=None,
            # reads flags..value and ptgt once (psrc is not read), writes
            # the five bool and two int32 lanes and the clock
            bytes=nbytes(flags, slot, ctr, obj, key, ref, value, ptgt)
            + nbytes(*out),
            ops=D * (2 * N * log2n + 4 * (N + 1) * rounds),
        )
        torch.cuda.synchronize()
        t_bytes = r["bytes"] / MEM_BYTES_PER_S * 1e3
        t_ops = r["ops"] / SCALAR_OPS_PER_S * 1e3
        r["bound_ms"] = max(t_bytes, t_ops)
        r["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        log(f"timing materialize_live [{D}, {N}]: " + " ".join(
            f"{k}={v!r}" for k, v in r.items()))
        res[label] = r
    return res


# (label, synth_batch config) of the bulk shapes doc_kernel.cu serves:
# the slab, a rank's share of it and of the product route's slab over
# MESH_RANKS, the multi-actor batch and a rank's share of it, and a batch
# of short docs at the live tick's device threshold (D x N = 131,072)
DOC_ROUTE_SHAPES = (
    ("slab", SLAB),
    ("slab rank", dict(SLAB, n_docs=SLAB["n_docs"] // MESH_RANKS)),
    ("product rank", dict(SLAB, n_docs=MESH_SLAB // MESH_RANKS)),
    ("multi", MULTI),
    ("multi rank", dict(MULTI, n_docs=MULTI["n_docs"] // MESH_RANKS)),
    ("short docs", dict(n_docs=2048, n_ops=64, n_actors=2, text_frac=0.5)),
)
# (D, N) of the grid on which the entry's route rule is read: D docs of N
# rows, up to 2^22 rows a batch
DOC_ROUTE_GRID = tuple(
    (D, N) for N in (1024, 2048, 4096, 8192, 16384, 65536)
    for D in (1, 8, 32, 64, 128, 256, 512) if D * N <= 1 << 22)


def time_doc_routes(ck, synth, live_cases):
    """Phase 4: doc_kernel.cu's routes forced on the same inputs (one
    block a doc with its scratch in shared memory, the same in global
    lanes, the many-block route; where a doc does not fit shared memory
    the first two are one and it runs once), at every bulk shape of
    DOC_ROUTE_SHAPES, over DOC_ROUTE_GRID and at the live ticks of
    `live_cases` ({label: (args, A, K)} in materialize_live_device's
    form): per route the wrapper (CUDA events, the routes taking turns)
    and the kernels alone (the profiler, summed), and the route the entry
    picks (`auto`) beside the one that read faster. The routes are held
    byte-equal first."""
    import torch

    pick = ck.kernel_fn("doc_route")
    cases = {}
    for label, cfg in DOC_ROUTE_SHAPES:
        batch = make_batch(synth, cfg)
        args, A, K = cuda_args(ck, batch)
        cases[f"{label} {list(batch.shape)}"] = (
            lambda route, args=args, A=A, K=K: ck.materialize_cuda(
                *args, A=A, K=K, route=route))
    for D, N in DOC_ROUTE_GRID:
        batch = make_batch(synth, dict(n_docs=D, n_ops=N, n_actors=2,
                                       text_frac=0.7, seed=D + N))
        args, A, K = cuda_args(ck, batch)
        cases[f"grid {list(batch.shape)}"] = (
            lambda route, args=args, A=A, K=K: ck.materialize_cuda(
                *args, A=A, K=K, route=route))
    for label, (args, A, K) in live_cases.items():
        cases[f"live {label}"] = lambda route, args=args, A=A, K=K: (
            doc_route_call(ck, args, A, K, route)())
    every = {"one_block": ck.DOC_ROUTE_ONE_BLOCK,
             "one_block_global": ck.DOC_ROUTE_ONE_BLOCK_GLOBAL,
             "many_block": ck.DOC_ROUTE_MANY_BLOCK}
    res = {}
    for label, call in cases.items():
        outs = [call(ck.DOC_ROUTE_MANY_BLOCK)]
        D, N = outs[0].rank.shape
        fits = pick(D, N, ck.DOC_ROUTE_ONE_BLOCK) == ck.DOC_ROUTE_ONE_BLOCK
        routes = {k: v for k, v in every.items()
                  if fits or k != "one_block"}
        outs += [call(route) for name, route in routes.items()
                 if name != "many_block"]
        for other in outs[1:]:
            for f in outs[0]._fields:
                if not torch.equal(getattr(outs[0], f), getattr(other, f)):
                    raise AssertionError(f"doc_kernel routes differ at "
                                         f"{label} in {f}")
        r = {}
        for _ in range(2):  # the routes take turns
            for name, route in routes.items():
                r.setdefault(f"{name}_ms", []).append(median_ms(
                    lambda: call(route), runs=5, warmup=1))
        for name, route in routes.items():
            r[f"{name}_ms"] = min(r[f"{name}_ms"])
            r[f"{name}_kernel_ms"], r[f"{name}_kernels"] = kernels_device_ms(
                lambda: call(route), DOC_KERNELS, runs=5)
        r["auto"] = {v: k for k, v in routes.items()}.get(
            pick(D, N, ck.DOC_ROUTE_AUTO))
        r["faster"] = min(routes, key=lambda name: r[f"{name}_ms"])
        if r["auto"] is None:
            raise AssertionError(f"doc_kernel picked no route at {label}")
        torch.cuda.synchronize()
        log(f"timing doc_kernel routes {label}: " + " ".join(
            f"{k}={v!r}" for k, v in r.items()))
        res[label] = r
    return res


def mesh_bounds(ck, ckk, slab, multi):
    """Bytes each phase-3e mesh program must move (inputs read once,
    outputs written once, summed over ranks) and its bound over
    MEM_BYTES_PER_S, at phase 3e's shapes."""
    import torch

    res = {}
    for lean in (False, True):
        args, A, K = cuda_args(ck, slab, lean=lean)
        out, wire = ck.run_batch_full(slab, lean=lean)
        b = nbytes(*args) + nbytes(*out) + nbytes(wire)
        res[f"sharded_full lean={lean} {list(slab.shape)}"] = b
    args, A, K = cuda_args(ck, multi)
    out = ck.materialize_cuda(*args, A=A, K=K)
    res[f"step {list(multi.shape)}"] = nbytes(*args) + nbytes(*out)
    n, a = CONFIG5["n_docs"], CONFIG5["n_actors"]
    res[f"union (pmax) [{n}, {a}]"] = 4 * (n * a + a)
    res[f"dominated (pmin) [{n}, {a}]"] = 4 * (n * a + a) + n
    torch.cuda.synchronize()
    out = {k: dict(bytes=v, bound_ms=v / MEM_BYTES_PER_S * 1e3)
           for k, v in res.items()}
    log("mesh_bounds " + json.dumps(out))
    return out


def host_split_ms(ck, fn, runs=50, warmup=5) -> dict:
    """A wrapper's host time split around its one call of doc_kernel.cu's
    C entry (medians, the card idle when each call starts): before it
    (checks, allocations, marshalling), the C call (the launches it
    issues), after it; and CUDA events around the C call alone (the
    device work it enqueues; their records fall inside the C call's
    time)."""
    import torch

    real, marks = ck.kernel_fn, []

    def timed(name):
        c = real(name)
        if name != "doc_kernel":
            return c

        def call(*a):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            rc = c(*a)
            end.record()
            marks.append((t0, time.perf_counter(), start, end))
            return rc
        return call

    ck.kernel_fn = timed
    try:
        for _ in range(warmup):
            fn()
        split = {"pre_ms": [], "c_ms": [], "post_ms": [], "c_events_ms": []}
        for _ in range(runs):
            torch.cuda.synchronize()
            marks.clear()
            t = time.perf_counter()
            fn()
            t_end = time.perf_counter()
            torch.cuda.synchronize()
            if len(marks) != 1:
                raise AssertionError(f"{len(marks)} doc_kernel calls")
            t0, t1, start, end = marks[0]
            split["pre_ms"].append((t0 - t) * 1e3)
            split["c_ms"].append((t1 - t0) * 1e3)
            split["post_ms"].append((t_end - t1) * 1e3)
            split["c_events_ms"].append(start.elapsed_time(end))
    finally:
        ck.kernel_fn = real
    return {k: statistics.median(v) for k, v in split.items()}


def sidecar_numbers(root: str) -> dict:
    """The sidecar slab (phase 3b's: 4,096 docs over 8 template feeds
    written to sidecars under `root`) through entries every tree of the
    port has: `sidecar_wall_ms` (pack_docs_columns on the card +
    run_batch_full + fetch_summary, lean as the tree's bulk loader picks
    it) and `sidecar_pack_ms` (the pack alone), host medians of 7 ending
    in a synchronize, and the slab's stages apart
    (`sidecar_stage_pack_ms`, `_dispatch_ms`, `_fetch_ms`, `_tail_ms`);
    `pack_prefix_ms`,
    pack_prefix_cuda on the inputs
    the pack hands it (CUDA events, median of 15), and its kernel alone
    (`pack_prefix_kernel_ms`, the profiler); one profiled slab's wall,
    idle share and copies by direction (`sidecar_profile`)."""
    import numpy as np
    import torch

    from hypermerge_tpu_torch.crdt.change import Action
    from hypermerge_tpu_torch.ops import columnar, synth
    from hypermerge_tpu_torch.ops import crdt_kernels as ck
    from hypermerge_tpu_torch.ops import materialize as mat
    from hypermerge_tpu_torch.ops import pack_kernels as pk
    from hypermerge_tpu_torch.storage import colcache

    hists = [synth.synth_changes(SLAB["n_ops"], n_actors=1,
                                 ops_per_change=16, seed=t)
             for t in range(TEMPLATES)]
    specs = slab_specs(sidecar_feeds(colcache, root, hists), SLAB["n_docs"])

    def pack():
        return columnar.pack_docs_columns(
            specs, n_docs=SLAB["n_docs"], n_rows=SLAB["n_ops"], device="cuda")

    def lean_of(b):
        if hasattr(b, "has_inc"):
            return not b.has_inc()
        return not bool(np.any(b.cols["action"] == int(Action.INC)))

    def slab():
        b = pack()
        lean = lean_of(b)
        _o, w = ck.run_batch_full(b, lean=lean)
        mat.fetch_summary(w, b, lean=lean)

    _b, calls = capture(pk, "pack_prefix", pack)
    k = calls[0][1]
    res = host_medians_ms({"sidecar_wall_ms": slab, "sidecar_pack_ms": pack})
    # the slab's stages apart (host clock, medians of 7 after 2): the
    # pack, the dispatch until it returns, fetch_summary (the wire's copy
    # and its host parse), then what the card still had to finish
    stages = {"pack": [], "dispatch": [], "fetch": [], "tail": []}
    for i in range(9):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        b = pack()
        t1 = time.perf_counter()
        lean = lean_of(b)
        _o, w = ck.run_batch_full(b, lean=lean)
        t2 = time.perf_counter()
        mat.fetch_summary(w, b, lean=lean)
        t3 = time.perf_counter()
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        if i >= 2:
            for name, dt in zip(stages, (t1 - t0, t2 - t1, t3 - t2, t4 - t3)):
                stages[name].append(dt * 1e3)
        del b, _o, w
    for name, v in stages.items():
        res[f"sidecar_stage_{name}_ms"] = statistics.median(v)
    res["pack_prefix_ms"] = median_ms(lambda: pk.pack_prefix_cuda(**k), 15, 3)
    res["pack_prefix_kernel_ms"] = kernel_device_ms(
        lambda: pk.pack_prefix_cuda(**k), "pack_prefix_kernel")
    res["sidecar_profile"] = profile_dispatch("ab sidecar slab", slab)
    return res


def open_numbers(corpus: str, root: str, key: str = "open_ms") -> dict:
    """{key: one host wall} of a cold open of `corpus` (Repo(path) on a
    copy of it, open_many of its urls and fetch_bulk_summaries) with the
    tree's defaults: phase 3d's open (`open_ms`), and the bench-size
    open of phase 3g (`open_bench_ms`; pipelined where the tree has the
    pipeline, serial in a tree without it)."""
    import shutil

    from hypermerge_tpu_torch.repo import Repo

    with open(os.path.join(corpus, "urls.json")) as f:
        urls = json.load(f)
    path = os.path.join(root, "open")
    shutil.copytree(corpus, path)
    repo = Repo(path=path)
    try:
        t0 = time.perf_counter()
        repo.open_many(urls)
        repo.back.fetch_bulk_summaries()
        return {key: (time.perf_counter() - t0) * 1e3}
    finally:
        repo.close()
        shutil.rmtree(path)


def pair_numbers() -> dict:
    """clock_pair at config 5's [131072, 64] through entries every tree
    of the port has, on a mirror seeded as config5_mirrors seeds it:
    pair_cuda(GTE, q, m)'s CUDA events (`pair_ms`), host time
    (`pair_host_ms`), the kernel alone warm (`pair_kernel_ms`, the
    profiler) and cold (`pair_cold_kernel_ms`, cold_kernel_ms), its bytes
    bound, the plain version, torch.all(m <= q) (two calls), and
    DeviceClockMirror.dominated's wall (`dominated_wall_ms`); and, where
    the tree has it, the host-query entry gte_host (`pair_gte_host_ms`,
    `pair_gte_host_host_ms`)."""
    import numpy as np
    import torch

    from hypermerge_tpu_torch.ops import clock_kernels as ckk
    from hypermerge_tpu_torch.ops import clock_mirror as PM

    n, A = CONFIG5["n_docs"], CONFIG5["n_actors"]
    clocks = np.random.default_rng(0).integers(1, 1000, size=(n, A),
                                                 dtype=np.int32)
    actors = [f"a{j}" for j in range(A)]
    mirror = PM.DeviceClockMirror(capacity_docs=n, capacity_actors=A)
    mirror.seed_bulk([f"d{i}" for i in range(n)], actors, clocks)
    m = mirror._mat()
    q = torch.full((A,), 990, dtype=torch.int32, device="cuda")
    out = ckk.pair_cuda(ckk._GTE, q, m)
    footprint = nbytes(m, q, out)
    mats = [m.clone() for _ in range(max(2, math.ceil(4 * L2_BYTES / nbytes(m))))]
    query = {a: 990 for a in actors}

    def call():
        return ckk.pair_cuda(ckk._GTE, q, m)

    res = dict(
        pair_ms=median_ms(call, 15, 3), pair_host_ms=host_call_ms(call),
        pair_kernel_ms=kernel_device_ms(call, "clock_pair_kernel"),
        pair_cold_kernel_ms=cold_kernel_ms(
            lambda i: (lambda: ckk.pair_cuda(ckk._GTE, q, mats[i % len(mats)])),
            footprint),
        pair_bound_ms=footprint / MEM_BYTES_PER_S * 1e3,
        pair_plain_ms=median_ms(lambda: ckk.gte_plain(q, m), 15, 3),
        pair_two_call_ms=median_ms(lambda: torch.all(m <= q, dim=-1), 15, 3),
        dominated_wall_ms=host_medians_ms(
            {"d": lambda: mirror.dominated(query)})["d"],
    )
    if hasattr(ckk, "gte_host"):
        qh = q.cpu().numpy()
        res["pair_gte_host_ms"] = median_ms(lambda: ckk.gte_host(qh, m), 15, 3)
        res["pair_gte_host_host_ms"] = host_call_ms(lambda: ckk.gte_host(qh, m))
    del mats
    return res


def slab_numbers(tree: str, corpus: str | None = None,
                 bench_corpus: str | None = None) -> int:
    """One JSON line of the port in `tree`, through entries every tree of
    the port has: `slab_full_ms` / `slab_lean_ms`, materialize_full_device
    / materialize_full_lean_device at SLAB (kernels 1 and 2, however many
    launches the tree takes; CUDA events, median of 15 after 3 warm-ups),
    `slab_peak_mb` (peak_mb of one full dispatch); `wire_ms` /
    `wire_long_doc_ms`, summary_wire_cuda alone at SLAB and at LONG_DOC;
    the sidecar slab (sidecar_numbers) and, with `corpus`, phase 3d's
    open (open_numbers), with `bench_corpus` phase 3g's (`open_bench_ms`);
    for the live tick's buckets (live_tick_cases)
    materialize_live_device's events (`_ms`), host time until it returns
    (`_host_ms`) and host_split_ms (`_pre_ms`, `_c_ms`, `_post_ms`,
    `_c_events_ms`); clock_pair's numbers and mirror.dominated's wall at
    config 5 (pair_numbers)."""
    sys.path.insert(0, os.path.abspath(tree))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from hypermerge_tpu_torch.backend import live
    from hypermerge_tpu_torch.kernels import _build
    from hypermerge_tpu_torch.ops import columnar, synth
    from hypermerge_tpu_torch.ops import crdt_kernels as ck

    if not ck.__file__.startswith(os.path.abspath(tree) + os.sep):
        raise AssertionError(f"imported {ck.__file__}, not from {tree}")
    _build.build()
    slab = make_batch(synth, SLAB)
    args, A, K = cuda_args(ck, slab)
    flags, slot, ctr, _seq, obj, key, ref, _value, psrc, ptgt, da = (
        cuda_args(ck, slab, lean=True)[0])
    N = slab.n_rows

    def full():
        return ck.materialize_full_device(*args, A=A, K=K)

    def lean():
        return ck.materialize_full_lean_device(
            flags, slot, ctr, obj, key, ref, psrc, ptgt, da, A=A, K=K)

    res = dict(slab_full_ms=median_ms(full, 15, 3),
               slab_lean_ms=median_ms(lean, 15, 3), slab_peak_mb=peak_mb(full))
    out = ck.materialize_cuda(*args, A=A, K=K)
    res["wire_ms"] = median_ms(
        lambda: ck.summary_wire_cuda(out, N, A, False), 15, 3)
    long_doc = make_batch(synth, LONG_DOC)
    la, lA, lK = cuda_args(ck, long_doc)
    lout = ck.materialize_cuda(*la, A=lA, K=lK)
    res["wire_long_doc_ms"] = median_ms(
        lambda: ck.summary_wire_cuda(lout, long_doc.n_rows, lA, False), 15, 3)
    with tempfile.TemporaryDirectory(prefix="hm-ab-") as root:
        res.update(sidecar_numbers(root))
        if corpus is not None:
            res.update(open_numbers(corpus, root))
        if bench_corpus is not None:
            res.update(open_numbers(bench_corpus, root, "open_bench_ms"))
    res.update(pair_numbers())
    for label, lvs in live_tick_cases(columnar, synth).items():
        targs, tA, tK = live_args(ck, live, lvs, "cuda")

        def tick(targs=targs, tA=tA, tK=tK):
            return ck.materialize_live_device(*targs, A=tA, K=tK)

        res[f"live_{label}_ms"] = median_ms(tick, 15, 3)
        res[f"live_{label}_host_ms"] = host_call_ms(tick)
        for k, v in host_split_ms(ck, tick).items():
            res[f"live_{label}_{k}"] = v
    print(json.dumps(res), flush=True)
    return 0


def storm_main(n: int) -> int:
    """`--storm N`: see the module docstring."""
    import threading

    import numpy as np

    from hypermerge_tpu_torch import native
    from hypermerge_tpu_torch.kernels import _build
    from hypermerge_tpu_torch.net.ipc import connect_frontend
    from hypermerge_tpu_torch.utils import chacha

    rng = np.random.default_rng(0)
    key, nonce = rng.bytes(32), rng.bytes(12)
    aead = {}
    for size in (100, 300, 1000, 65536, 1 << 20):
        msg = rng.bytes(size)
        reps = max(3, min(200, (1 << 16) // size))
        walls = []
        for _ in range(reps):
            t0 = time.perf_counter()
            ct = chacha.aead_encrypt(key, nonce, msg)
            t1 = time.perf_counter()
            if chacha.aead_decrypt(key, nonce, ct) != msg:
                raise AssertionError("chacha: the frame did not open")
            walls.append((t1 - t0, time.perf_counter() - t1))
        aead[size] = {"seal_ms": statistics.median(w[0] for w in walls) * 1e3,
                      "open_ms": statistics.median(w[1] for w in walls) * 1e3}
    log("storm aead " + json.dumps({
        "libsodium": bool(native.caps() & native.CAP_SODIUM),
        "utils/chacha.py": aead}))
    _build.build()
    for poll in (False, True):
        for i in range(n):
            with tempfile.TemporaryDirectory(prefix="hm-storm-") as root:
                stop, polls = threading.Event(), [0]

                def watch():
                    sock = os.path.join(root, "daemon.sock")
                    while not stop.wait(0.5):
                        try:
                            front, close = connect_frontend(sock)
                            break
                        except OSError:  # the daemon is not up yet
                            pass
                    else:
                        return
                    stop.wait(10)  # past the clients' set-up
                    while not stop.wait(0.2):
                        got = []
                        front.telemetry(got.append)
                        deadline = time.time() + 2
                        while not got and time.time() < deadline:
                            time.sleep(0.01)
                        polls[0] += bool(got)
                    close()

                th = threading.Thread(target=watch, daemon=True)
                if poll:
                    th.start()
                try:
                    r = service_storm(root)
                finally:
                    stop.set()
                    if poll:
                        th.join(10)
            log("storm " + json.dumps({
                "poll": poll, "run": i, "telemetry_polls": polls[0],
                "recovery_to_slo_s": r["recovery_to_slo_s"],
                "recovery_probes": r["recovery_probes"],
                "steady": r["steady"], "saturation_qps": r["saturation_qps"],
                "storm": r["storm"], "gates": r["gates"]}))
    log(card_line())
    return 0


def ab_main(other: str, rounds: int) -> int:
    """`--ab OTHER [ROUNDS]`: slab_numbers of OTHER and of this tree in
    turn, each in a process of its own, on one corpus of phase 3d's size
    and one of phase 3g's, written first by this tree's make_corpus
    (without .sig sidecars); exits non-zero if any fails."""
    from hypermerge_tpu_torch.ops.corpus import make_corpus

    here = os.path.dirname(os.path.abspath(__file__))
    order = [("other", other), ("this", here), ("this", here),
             ("other", other)] * rounds
    with tempfile.TemporaryDirectory(prefix="hm-ab-corpus-") as root:
        corpus, bench = os.path.join(root, "read"), os.path.join(root, "open")
        for where, cfg in ((corpus, READ), (bench, BENCH_OPEN)):
            urls = make_corpus(where, cfg["n_docs"], cfg["n_ops"],
                               sign=False)
            with open(os.path.join(where, "urls.json"), "w") as f:
                json.dump(urls, f)
        for label, tree in order:
            run = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--slab-numbers",
                 tree, corpus, bench], capture_output=True, text=True,
                timeout=900)
            if run.returncode != 0:
                print(run.stdout + run.stderr, file=sys.stderr)
                return run.returncode or 1
            log(f"ab {label} {run.stdout.strip().splitlines()[-1]}")
    log(card_line())
    return 0


def main() -> int:
    if sys.argv[1:2] == ["--ab"]:
        return ab_main(sys.argv[2], int(sys.argv[3]) if sys.argv[3:] else 1)
    if sys.argv[1:2] == ["--slab-numbers"]:
        return slab_numbers(*sys.argv[2:5])
    if sys.argv[1:2] == ["--storm"]:
        return storm_main(int(sys.argv[2]))
    if sys.argv[1:2] == ["--lockdep-child"]:
        return lockdep_child(*sys.argv[2:7])
    if sys.argv[1:2] == ["--lockdep"]:
        return lockdep_main()
    if sys.argv[1:2] == ["--tools"]:
        return tools_main()
    if sys.argv[1:2] == ["--twins"]:
        return twins_main()
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from hypermerge_tpu_torch.crdt.change import ROOT, Action, Change, Op
        from hypermerge_tpu_torch import native
        from hypermerge_tpu_torch.backend import live
        from hypermerge_tpu_torch.kernels import _build
        from hypermerge_tpu_torch.ops import clock_kernels as ckk
        from hypermerge_tpu_torch.ops import clock_mirror as PM
        from hypermerge_tpu_torch.ops import columnar, synth
        from hypermerge_tpu_torch.ops import crdt_kernels as ck
        from hypermerge_tpu_torch.ops import materialize as mat
        from hypermerge_tpu_torch.ops import pack_kernels as pk
        from hypermerge_tpu_torch.parallel import mesh as meshmod
        from hypermerge_tpu_torch.parallel import ring as ringmod
        from hypermerge_tpu_torch.parallel import sharded
        from hypermerge_tpu_torch.serve import kernels as sk
        from hypermerge_tpu_torch.storage import colcache, sql, stores
    except ImportError as e:
        print(f"chip_smoke: the port's package is missing: {e}",
              file=sys.stderr)
        return 2
    if "jax" in sys.modules or any(
        m.startswith("hypermerge_tpu.") or m == "hypermerge_tpu"
        for m in sys.modules
    ):
        raise AssertionError("the port imported jax or the JAX package")

    # -- 1. build + device line ---------------------------------------------
    t_start = time.perf_counter()

    def elapsed(after):
        log(f"elapsed {time.perf_counter() - t_start:.1f} s after {after}")

    card = card_line()
    log(card)
    # the --devices dump (python -m bench_torch --devices): the port's
    # device topology beside the card's name and power limit
    log("topology " + json.dumps(dict(meshmod.device_topology(), card=card)))
    t0 = time.perf_counter()
    _build.build()
    log(f"phase 1 build: {time.perf_counter() - t0:.1f} s")
    log(toolkit_line())
    log(f"phase 1 parameter caps: clock_scatter "
        f"{ck.launch_cap('clock_scatter')} triples a launch, serve_order "
        f"{ck.launch_cap('serve_order', 0)} entries a launch, "
        f"{ck.launch_cap('serve_order', 1)} keys in shared memory, "
        f"serve_counts {ck.launch_cap('serve_counts', 0)} entries a launch, "
        f"clock_pair's query row {ck.launch_cap('clock_pair', 0)} ints by "
        f"value ({ck.launch_cap('clock_pair', 1)} in its small struct); "
        f"pack_prefix at most {ck.launch_cap('pack_prefix', 0)} threads a "
        f"block, {ck.launch_cap('pack_prefix', 1)} cells a thread, grid from "
        f"{ck.launch_cap('pack_prefix', 2)} SMs and "
        f"{ck.launch_cap('pack_prefix', 3)} bytes of shared memory a block")
    for stem, text in _build.build_log.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {stem}: {line.strip()}")
    t0 = time.perf_counter()
    lib = native.load()
    log(f"phase 1 native library: loaded={lib is not None} "
        f"caps={native.caps()} (sodium={bool(native.caps() & native.CAP_SODIUM)}"
        f", brotli={bool(native.caps() & native.CAP_BROTLI)}) in "
        f"{time.perf_counter() - t0:.1f} s; error={native.load_error!r}")

    with tempfile.TemporaryDirectory(prefix="hm-sidecars-") as root:
        # the sidecar slab's template feeds (the bench corpus' shape:
        # single writer, 1024 ops in changes of 16)
        hists = [
            synth.synth_changes(SLAB["n_ops"], n_actors=1, ops_per_change=16,
                                seed=t)
            for t in range(TEMPLATES)
        ]
        fcs = sidecar_feeds(colcache, root, hists)
        wide = value_tail(hists[3], (Action, Change, Op, ROOT))
        big = synth.synth_changes(65536, n_actors=1, ops_per_change=16,
                                  seed=99)
        fc_wide, fc_big = sidecar_feeds(colcache, f"{root}/x", [wide, big])

        # -- 2. kernels vs plain, on the card ---------------------------------
        slab = make_batch(synth, SLAB)
        multi = make_batch(synth, MULTI)
        long_doc = make_batch(synth, LONG_DOC)
        errs = compare_kernels(ck, slab, "slab")
        rank_slab = make_batch(synth, dict(SLAB, n_docs=SLAB["n_docs"]
                                           // MESH_RANKS))
        for b, label in ((multi, "multi"), (rank_slab, "slab rank"),
                         (long_doc, "long doc")):
            for k, e in compare_kernels(ck, b, label).items():
                errs[k] = max(errs[k], e)
        del rank_slab
        e_slab, k_slab = compare_pack(
            pk, columnar, slab_specs(fcs, SLAB["n_docs"]), "slab",
            n_docs=SLAB["n_docs"], n_rows=SLAB["n_ops"],
        )
        half = fcs[1].n_changes // 2
        ragged = [[(fcs[0], 0, INF)], [(fcs[1], 0, half)], [(fcs[0], 0, INF)],
                  [(fcs[2], 0, 0)], [(fc_wide, 0, INF)]]
        e_ragged, k_ragged = compare_pack(
            pk, columnar, ragged, "ragged", n_docs=8, n_rows=2048
        )
        if k_ragged["row32"] or k_ragged["Dp"] != 8:
            raise AssertionError("ragged pack: expected [8, 2048] int16 rows")
        e_big, k_big = compare_pack(
            pk, columnar, [[(fc_big, 0, INF)]], "i16ok=False"
        )
        if not k_big["row32"] or k_big["N"] != 65536:
            raise AssertionError("the 65,536-row doc did not pack int32 rows")
        errs["pack_prefix"] = max(e_slab, e_ragged, e_big)
        errs.update(compare_clock_kernels(ckk))
        errs.update(compare_serve_kernels(synth, sk))
        errs.update(compare_mesh_kernels(ringmod, meshmod, ckk))
        errs["materialize_live"], live_inputs, live_cases = (
            compare_live_kernel(ck, live, columnar, synth))
        elapsed("phase 2")

        # -- 3. the main paths -------------------------------------------------
        slice1 = main_path(ck, mat, synth, columnar, slab, long_doc)
        batch, out, arrays, lean, counts = slice_path(ck, columnar, mat, fcs)
        check_slice(ck, columnar, mat, hists, batch, out, arrays, lean)
        clock_counts, mirror, actors = clock_path(ck, PM)
        store_path(ck, PM, sql, stores)
        refs = mesh_references(ck, ckk, slab, multi)
        elapsed("phases 3a-3c")
        with tempfile.TemporaryDirectory(prefix="hm-read-") as read_root:
            read_counts, read_numbers, seen, last, urls, rows = read_path(
                ck, sk, read_root)
            mesh_counts, gather_shape, mesh_walls = mesh_path(
                ck, meshmod, sharded, slab, multi, refs, read_root, urls,
                rows, virtual_ranks(MESH_RANKS), "virtual ranks")
            n_cards = torch.cuda.device_count()
            if n_cards >= 2:
                cards = [torch.device("cuda", i)
                         for i in range(min(n_cards, MESH_RANKS))]
                mesh_path(ck, meshmod, sharded, slab, multi, refs, read_root,
                          urls, rows, cards, "peer ranks")
            else:
                log(f"phase 3e peer ranks: not run ({n_cards} GPU visible)")
            # phase 3h's real repo: a copy of phase 3d's corpus (never
            # hard links: the writer and recovery write through them)
            crash_corpus = os.path.join(root, "crash-corpus")
            shutil.copytree(read_root, crash_corpus)
            # and phase 3l's, which writes durably through it
            service_corpus = os.path.join(root, "service-corpus")
            shutil.copytree(read_root, service_corpus)
            # and phase 3n's two: one opened plain, one instrumented
            lockdep_corpora = tuple(
                os.path.join(root, f"lockdep-{w}") for w in ("plain", "dep"))
            for c in lockdep_corpora:
                shutil.copytree(read_root, c)
        del refs
        elapsed("phases 3d-3e")
        with tempfile.TemporaryDirectory(prefix="hm-live-") as live_root:
            live_launches, live_numbers, _captured = live_path(ck, live_root)
        del _captured
        elapsed("phase 3f")
        with tempfile.TemporaryDirectory(prefix="hm-open-") as open_root:
            open_counts, open_numbers = pipeline_path(ck, open_root)
        elapsed("phase 3g")
        with tempfile.TemporaryDirectory(prefix="hm-crash-") as crash_root:
            crash_numbers = crash_path(ck, crash_root, crash_corpus, urls,
                                       rows)
        shutil.rmtree(crash_corpus)
        del rows
        elapsed("phase 3h")
        # a fresh directory: 3h's killed writer must not reach the corpus
        with tempfile.TemporaryDirectory(prefix="hm-net-") as net_root:
            net_counts, net_numbers = net_path(ck, net_root)
        elapsed("phase 3i")
        chaos_counts, chaos_numbers = chaos_path(ck)
        elapsed("phase 3j")
        # after every kernel was built (phase 1): the hub's workers load the
        # built libraries and never compile
        hub_counts, hub_numbers = hub_path(ck)
        elapsed("phase 3k")
        service_counts, service_numbers = service_path(ck, service_corpus,
                                                       urls)
        shutil.rmtree(service_corpus)
        elapsed("phase 3l")
        files_counts, files_numbers = files_path(ck)
        elapsed("phase 3m")
        lockdep_counts, _lockdep_numbers = lockdep_path(ck, lockdep_corpora,
                                                        urls)
        elapsed("phase 3n")
        # the command-line tools on 3n's plain copy, before it goes
        tools_counts, _tools_numbers = tools_path(ck, lockdep_corpora[0],
                                                  urls)
        for c in lockdep_corpora:
            shutil.rmtree(c)
        elapsed("phase 3o")
        # the main path's reference cases, the kernels on the card
        twins_counts, _twins_numbers = twins_path(ck)
        elapsed("phase 3p")

        # -- 4. times ------------------------------------------------------
        timing = time_kernels(ck, slab, long_doc)
        for name, r in timing.items():
            log(f"timing slab {slab.shape} {name}: " + " ".join(
                f"{k}={v!r}" for k, v in r.items()))
        for name, r in time_kernels(ck, multi).items():
            log(f"timing multi {multi.shape} {name}: ms={r['ms']!r} "
                f"plain_ms={r['plain_ms']!r} library_ms={r['library_ms']!r} "
                f"bound_ms={r['bound_ms']!r} ({r['bound_by']})")
        timing["pack_prefix"] = time_pack(pk, ck, columnar, mat, fcs,
                                          k_slab, lean)
        time_pack_shape(pk, "ragged", k_ragged)
        time_pack_shape(pk, "i16ok=False", k_big)
        clock_timing, hot_ms = time_clock_kernels(ckk, PM, mirror, actors)
        timing.update(clock_timing)
        timing.update(time_serve_kernels(sk, seen, last))
        timing.update(time_mesh_kernels(ringmod, meshmod, ckk, gather_shape))
        mesh_bounds(ck, ckk, slab, multi)
        live_timing = time_live_kernel(ck, live, live_inputs)
        timing["materialize_live"] = live_timing["1x262144"]
        time_doc_routes(ck, synth, live_cases)
        del live_inputs, live_cases
        if torch.cuda.device_count() >= 2:
            time_peer_ring(ringmod, meshmod, [
                torch.device("cuda", i)
                for i in range(min(torch.cuda.device_count(), MESH_RANKS))])
        else:
            log("timing ring_gather peer: not measured (1 GPU visible)")
        del seen, last
        del mirror
        profile_dispatch("first-slice slab dispatch",
                         lambda: ck.run_batch_full(slab))
        elapsed("phase 4")

    meta = {
        "pack_prefix": ("hypermerge_tpu_torch/kernels/csrc/pack_prefix.cu",
                        "hypermerge_tpu/ops/pack_kernels.py:73"),
        "materialize": ("hypermerge_tpu_torch/kernels/csrc/doc_kernel.cu",
                        "hypermerge_tpu/ops/crdt_kernels.py:100"),
        "summary_wire": ("hypermerge_tpu_torch/kernels/csrc/summary_wire.cu",
                         "hypermerge_tpu/ops/crdt_kernels.py:380"),
        "materialize_wire": ("hypermerge_tpu_torch/kernels/csrc/doc_kernel.cu",
                             "hypermerge_tpu/ops/crdt_kernels.py:506"),
        "clock_pair": ("hypermerge_tpu_torch/kernels/csrc/clock_pair.cu",
                       "hypermerge_tpu/ops/clock_kernels.py:28"),
        "clock_union": ("hypermerge_tpu_torch/kernels/csrc/clock_union.cu",
                        "hypermerge_tpu/ops/clock_kernels.py:56"),
        "clock_scatter": ("hypermerge_tpu_torch/kernels/csrc/clock_scatter.cu",
                          "hypermerge_tpu/ops/clock_mirror.py:50"),
        "clock_topk": ("hypermerge_tpu_torch/kernels/csrc/clock_topk.cu",
                       "hypermerge_tpu/ops/clock_kernels.py:81"),
        "serve_lookup": ("hypermerge_tpu_torch/kernels/csrc/serve_lookup.cu",
                         "hypermerge_tpu/serve/kernels.py:87"),
        "serve_order": ("hypermerge_tpu_torch/kernels/csrc/serve_order.cu",
                        "hypermerge_tpu/serve/kernels.py:102"),
        "serve_counts": ("hypermerge_tpu_torch/kernels/csrc/serve_counts.cu",
                         "hypermerge_tpu/serve/kernels.py:120"),
        "ring_gather": ("hypermerge_tpu_torch/kernels/csrc/ring_gather.cu",
                        "hypermerge_tpu/parallel/sharded.py:134"),
        "clock_union_min": ("hypermerge_tpu_torch/kernels/csrc/clock_union.cu",
                            "hypermerge_tpu/parallel/sharded.py:360"),
        "materialize_live": ("hypermerge_tpu_torch/kernels/csrc/doc_kernel.cu",
                             "hypermerge_tpu/ops/crdt_kernels.py:553"),
    }
    # launches: each kernel's count on its slice's main path (the bulk
    # kernels: the pipelined cold open's route b, phase 3g, beside the
    # sidecar slice's one; kernels 1 and 2 apart: the first slice, whose
    # long doc's slab takes them; the config-5 clock slice, the read slice)
    sidecar_counts = {k: counts[k] for k in BULK}
    counts.update({k: open_counts[k] for k in BULK})
    counts.update({k: slice1[k] for k in ("materialize", "summary_wire")})
    counts.update({k: clock_counts[k] for k in CLOCKS})
    counts.update({k: read_counts[k] for k in SERVE})
    counts.update({k: mesh_counts[k] for k in MESH})
    counts["materialize_live"] = live_launches
    # the network slice's launches (3i (a)'s kernel run, (b)'s reopen) join
    # the counts, and stand beside them
    for k, v in net_counts.items():
        counts[k] += v
    # and so do the churn slice's (3j's four runs), the hub slice's (3k's
    # shards reopened in this process) and the service slice's (3l (a)'s
    # open and reads)
    for k, v in chaos_counts.items():
        counts[k] += v
    for k, v in hub_counts.items():
        counts[k] += v
    for k, v in service_counts.items():
        counts[k] += v
    # and the hyperfile slice's (3m (a)'s reopen), and the instrumented
    # child's of phase 3n ((b)'s open and reads, (c)'s burst, (d))
    for k, v in files_counts.items():
        counts[k] += v
    for k, v in lockdep_counts.items():
        counts[k] += v
    # and the command-line tools' (3o (a): `meta --stats` in this process)
    for k, v in tools_counts.items():
        counts[k] += v
    # and the reference cases' (3p (a)-(f))
    for k, v in twins_counts.items():
        counts[k] += v
    clock_shape = [131072, CONFIG5["n_actors"]]
    shapes = {"ring_gather": list(gather_shape),
              "clock_union_min": [2, CONFIG5["n_docs"] // 2],
              "materialize_live": [1, LIVE_TRACE["bucket"]]}
    kernels = []
    for name, (source, replaces) in meta.items():
        r = timing[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": counts[name],
            "max_abs_err": errs[name], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "shape": (clock_shape if name in CLOCKS
                      else [r["B"], r["N"]] if name in SERVE
                      else shapes[name] if name in shapes
                      else list(slab.shape)),
            # the other readings where this run took them: the wrapper's
            # host work, the kernel alone (profiler; cold), the flush and
            # the library dispatch
            **{k: r[k] for k in EXTRA_READINGS if k in r},
            **({"sidecar_slice_launches": sidecar_counts[name]}
               if name in BULK else {}),
            **({"net_slice_launches": net_counts[name]}
               if name in net_counts else {}),
            **({"chaos_slice_launches": chaos_counts[name]}
               if name in chaos_counts else {}),
            **({"hub_slice_launches": hub_counts[name]}
               if name in hub_counts else {}),
            **({"service_slice_launches": service_counts[name]}
               if name in service_counts else {}),
            **({"files_slice_launches": files_counts[name]}
               if name in files_counts else {}),
            **({"lockdep_slice_launches": lockdep_counts[name]}
               if name in lockdep_counts else {}),
            **({"tools_slice_launches": tools_counts[name]}
               if name in tools_counts else {}),
            **({"twins_slice_launches": twins_counts[name]}
               if name in twins_counts else {}),
        })
    log(f"config5_hot_query_ms={hot_ms!r}")
    log("mesh_walls " + json.dumps(mesh_walls))
    log("read_mix " + json.dumps(read_numbers))
    log("live " + json.dumps(live_numbers))
    log("pipeline_open " + json.dumps(open_numbers))
    log("crash " + json.dumps(crash_numbers))
    log("net " + json.dumps(net_numbers))
    log("chaos " + json.dumps(chaos_numbers))
    log("hub " + json.dumps(hub_numbers))
    log("service " + json.dumps(service_numbers))
    log("files " + json.dumps(files_numbers))
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
