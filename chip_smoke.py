"""Chip smoke test of the PyTorch / CUDA port (``delphi_tpu_torch``).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases (any failure exits non-zero, and no result line is printed):

1. device: require CUDA, print the card and its power limit;
2. build: compile the port's CUDA kernels from ``delphi_tpu_torch/csrc``;
3. kernels: K1 ``pair_counts`` and K2 ``entropy_terms`` against their
   plain PyTorch versions at n = 1,000,000 (one pair of vocabularies 9x4,
   255x255, 2047x2047, an all-NULL pair, n = 1; all 28 pairs of 8 columns
   of vocabularies 2 to 200; all 153 pairs of 18 columns, which split into
   several launches), K2 twice on each input (bit-identical);
4. end to end at default options (the CV grid search for every target):
   ``delphi.repair...run()`` on a seeded 1,000,000-row table shaped like
   the gauntlet's ``missing_heavy`` scenario (22% NULLs on tier, band and
   grade), with the kernels' launch counts zeroed just before and read
   just after; it prints each target's chosen config, CV score, CV-proven
   rounds and chunk steps, and the training wall split into CV search and
   final fit; sequential training runs through the pipeline thread (on by
   default on the card) and weak-label demotion through the bucketed domain
   route, whose kernel K5 ``domain_scores`` must launch, in its
   weak-label mode (the f64 combine, the beta mask and the rank tie-break
   on the card; one result per cell comes back); its domain span and the
   bytes the domain phase copied off the card are printed (as for 4f b).
   In 4b each kernel is re-run, held against its plain version (K1 and K5
   bitwise, K2 within 1e-12 relative) and timed on the inputs that each
   driven path (4, 4n, 4c, 4d, 4f, 4g, 4h, 4i, 4j, 4k, 4l, 4r, 4t) gave it,
   reported per path, K5 in the mode that path launched: the integer mode
   on the paths with a ledger (escalation, incremental, resilience,
   gauntlet), the
   weak-label mode on the others; the main path's weak-label launches are
   also held against the host numpy route (the integer mode on the same
   operands, ``_combine_scores`` and the host pick: every has_domain and
   every top of a cell with a domain equal), and both table branches of
   K5 (pair tables staged in shared memory, and a synthetic piece whose
   tables exceed the budget, read through ``__ldg``) launch in both modes
   and equal the plain version; the three wrappers are run on the paths'
   inputs under ``torch.cuda.set_sync_debug_mode("error")`` (a
   synchronisation fails); K3 (``gbdt_hist``, ``gbdt_split``,
   ``gbdt_route``: the tree builder's level kernels) and K4
   (``gbdt_predict``) launch on every traced path that trains a GBDT (4,
   4n, 4c, 4f, 4r's cold request, 4t; 4d trains only the logistic head)
   and on each 4o rank, or the run fails; every traced path and every
   rank of 4m, 4o and 4p records the first K3 / K4 call of each structure
   (``gbdt_key``: the shapes but the row count, the levels, bins, channel
   slots, tree-to-model map and hyperparameter kinds), each held bitwise
   against its plain version right after its path (the ranks' in their
   phase); the heaviest call of each kernel on each traced path is timed
   and run under the sync check too, K3a's with its order floor (its
   longest per-bin chain times one dependent add's latency, measured at
   the start by ``delphi_add_chain``); K3a and K3b run the edge shapes of
   ``GBDT_EDGES`` (a skewed bin, one to 256 bins, an empty node, partial
   windows and rounds, 55 features, every C, -0.0 / inf / NaN values)
   bitwise against their plain versions on the card (:func:`gbdt_edges`),
   K3c and K4 those of ``GBDT_ROUTE_EDGES`` and ``GBDT_PREDICT_EDGES``
   (:func:`gbdt_route_edges`), one launch a call; every traced path that
   fits the logistic head on the card records the first K10 call of each
   structure (:func:`k10_key`), held bitwise against its plain version
   right after its path, its heaviest call of each kernel timed (the
   library yardsticks: ``index_add_`` for K10b's ``gWcat``, a fused
   ``torch.optim.Adam`` step for K10c; K10b's order floor, its longest
   chain of adds times one add's latency) and run under the sync check;
   and K10a, K10b and K10c run the shapes of ``LOGREG_EDGES`` (every
   route of K10a and K10b; among them the corners of K10b's ring: a
   chain of 25,000 occurrences, k 41 and 2, ids of one ring stage and one
   more or less, 20,000 short ids; and k 128 to 33,000) bitwise against
   their plain versions (:func:`logreg_edges`), one launch a call;
   4c. the same table through batched training
   (``setParallelStatTrainingEnabled(True)``): the same frame, at least
   one multi-target CV launch and one batched fit launch, no fallback;
   4d. a seeded 200,000-row table whose one NULL-bearing column has 40
   classes: it must train the logistic head on its gather route, launch
   K10a ``logreg_forward``, K10b ``logreg_backward`` and K10c
   ``adam_step`` at least once an applied step, and repair at least 0.85;
   it prints the launches, steps, ms a step and the training span, the
   same fit warm on a 10,000-row sample, a fresh process's first fit on
   that sample timed from the interpreter's start (``torch._dynamo`` must
   stay unloaded), and a fresh process's first ``torch.optim.Adam`` (the
   same host's yardstick);
   4e. one boosting round of a CV step at the 1M run's shapes, depths 3
   and 5: ms, the kernels the profiler saw and the K3 launches (one K3a
   per level and one for the leaf sums, one K3b and one K3c per level);
   4f. the constraints path, on a seeded 1,000,000-row table shaped like
   the gauntlet's ``fd_categorical`` (``fd_table``: typos, NULLs and
   FD-violating rewrites on state and region, outliers on amount), with
   the NULL, regex, denial-constraint (``city->state;state->region`` and a
   one-tuple constraint) and Gaussian-outlier detectors:
   (a) ``detect_errors_only`` on the card, identical to the CPU's frame;
   (b) the full run at default options as a main path (counts zeroed just
   before, read just after): wall, phase walls, error cells before and
   after demotion, repairs with precision and recall against the injected
   cells, cells the one-tuple minimization reverted, the ``detect.*``
   device steps and K1/K2 launches (each at least one);
   (c) the default detector set, and a run given the injected cells
   through ``setErrorCells`` (precision at least 0.9);
   (d), CPU against card (the full run with these detectors, the default
   detectors and ``setErrorCells``), is a card test at 2,000 rows
   (``tests/test_torch_cuda.py``);
   (e) every constraint route on 200,000 rows, card against CPU, which
   also reaches the rank and group-extrema steps the fd table's
   constraints do not;
   4g. rules and PMF: (a) ``fd_table`` at 200,000 rows through the
   NULL, regex (state) and FD-constraint (``city->state;state->region``)
   detectors with ``setRepairByRules(True)``, the regex and nearest-value
   rules on and a Levenshtein cost on state, as a main path ("rules"):
   wall, phase walls, the FD ``y <- x`` rules chosen (at least one), the
   cells each rule repaired, precision and recall against the injected
   cells, K1/K2 launches; (b) the 100,000-row missing_heavy table through
   ``compute_repair_candidate_prob`` (a main path, "pmf"),
   ``compute_repair_prob``, ``compute_repair_score`` and
   ``maximal_likelihood_repair`` (Levenshtein, delta 10,000), each run
   again in blocks of 25,000 dirty rows: the same frame; (c), CPU against
   card, is a card test at 2,000 rows since slice 9
   (``tests/test_torch_cuda.py``, :func:`rules_pmf_cross_check`);
   4h. misc and CLI: (a) ``generateDepGraph`` on 200,000 rows of
   ``fd_table`` as a main path ("depgraph"), and its dot text at 20,000
   rows equal on the CPU and the card; (b) ``splitInputTable`` at 200,000
   rows on the card, bisecting and k-means++ at k = 4, labels at 50,000
   rows equal to the CPU's, and one Lloyd iteration at 200,000 x 1024,
   k = 2, timed; (c) ``python -m delphi_tpu_torch.main --constraints`` on
   100,000 rows in a subprocess, its CSV equal to the in-process run's;
   4i. the provenance ledger and the escalation tier: (a) a 200,000-row
   ``missing_heavy`` run at 4's options, without and with
   ``DELPHI_PROVENANCE_PATH`` pointed at a file: the same frame, one
   decided entry per detected cell, both walls, the ledger's share (per-cell
   records, the JSONL write, the extra ``predict_proba``) and the file's
   size; (b) ``escalation_table`` at 200,000 rows with the NULL and
   regex detectors, without escalation and then with ``repair.escalate``
   at a budget of 32,768 as a main path ("escalation"): routed cells,
   each tier's attempts, repairs and wall, K8's launches with their
   ``(n_pad, V_pad)`` and each one's ms against its bound, the cell F1
   against the generator's truth off and on (on no lower; tier B on at
   least 4,096 cells); (c), CPU against card with ledger entries, is a
   card test at 2,000 rows since slice 9 (``tests/test_torch_cuda.py``,
   :func:`escalation_cross_check`); (d) ``python -m
   delphi_tpu_torch.main --escalate --provenance-out`` on 20,000 rows at a
   budget of 4,096 in a subprocess, its CSV equal to the in-process run's
   and its ledger file starting with the store's envelope header;
   4j. incremental and streaming repair on ``incremental_table`` (the JAX
   package's ``bench._incremental_frames``, rebuilt with numpy; NULL and
   ``EQ(t1.c0,t2.c0)&IQ(t1.c3,t2.c3)`` detectors, an in-memory ledger):
   (a) 200,000 rows, then 20,000 appended in groups 0-3 (1,000,000 and
   100,000 ran past the script's time; the run prints the size): populate
   (``repair.incremental`` with no manifest yet), delta as a main path
   ("incremental"), fresh (incremental off); the delta frame identical to
   the fresh one, rows pulled in by the constraint, fewer rows scanned by
   detection and fewer cells scored, a model reused, ledger cells spliced,
   K1 and K2 launched, a ``state.pkl`` without a tensor on the card; the
   three walls, their phase walls (``incremental.load / plan / manifest /
   snapshot_write`` among them), the snapshot's bytes and the fresh/delta
   ratio (reported, not gated); (b) 20,000 rows, CPU against card, through
   populate, an append delta and an update delta (``c2`` rewritten in one
   4,096-row block): frames, plans and ledger entries equal; (c) ``python
   -m delphi_tpu_torch.main --stream 4 --snapshot-dir D`` on a 200,000-row
   table shaped like ``bench._stream_frames``, its CSV equal to one batch
   CLI run's, then ``--fsck D`` exit 0, and exit 4 once a byte of D's
   manifest is flipped (the manifest quarantined);
   4k. the resilience plane (``parallel/resilience.py``): (a) the 1M
   ``missing_heavy`` table with ``DELPHI_CHECKPOINT_DIR`` set: run A under
   the plan ``gbdt.*:1:fatal`` raises ``FaultInjected`` with
   ``phase_detect.pkl`` on disk, run B resumes (one checkpoint hit) and
   trains, run C hits both checkpoints and skips training; B's and C's
   frames identical to 4's; walls, file bytes, save and load seconds;
   (b) 200,000 rows with an in-memory ledger (the unfaulted frame is
   (e)'s first run): ``freq.pairs_pallas:1:oom``
   retries once and K1 launches on the card (a main path, "resilience"),
   its frame identical to the unfaulted run's; three OOMs there reach the
   CPU rung, which a run on the card refuses: the run re-raises the OOM
   (one ``resilience.cpu_refused`` note, nothing latched, K1 never falls
   back to its plain version), and the next run's frame is the unfaulted
   one again; a real
   allocator failure classifies as ``oom``, a failed launch's message as
   no fault; (c) the CLI at 20,000 rows: ``--checkpoint-dir`` twice (both
   checkpoints hit, equal CSVs), ``--fault-plan store.checkpoint:1:crash``
   exits 23 in a subprocess and the re-run's CSV equals the first; (d)
   20,000 rows at ``model.hp.max_evals=1``, CPU against card under (a)'s
   plan and (b)'s retry: frames, ``resilience.*`` counters and per-site guarded
   entries equal; (e) 200,000 rows with ``model.checkpoint_path``: the
   second run reuses the models (``train.checkpoint_hits``) with an
   identical frame, and the pickle holds no tensor on the card. Every
   other phase's run asserts zero ``resilience.faults.*`` and
   ``resilience.degrade.*`` counts, and prints its guarded entries per
   site;
   4l. the planes of slice 9: (a) 4's 1M run (pipelined, the default on
   the card) against the same table with ``DELPHI_PIPELINE=0``: the same
   frame, both walls, training spans, ``pipeline.*`` counters and the
   consumer's wait; (b) ``fd_table`` at 200,000 rows with 4f's detectors
   at one GBDT config per target, under the bucketed domain route (traced
   as path "bucketed") and ``DELPHI_DEVICE_TABLE=0``: error cells after
   demotion and frames identical, both domain spans, K5's launches (none
   on the legacy route) and the ``launch.phase.domain.*`` counters; (c) a
   200,000-row ``missing_heavy`` table at ``model.hp.max_evals=1`` twice
   with ``DELPHI_PLAN_DIR``: the second run loads its plans
   (``launch.plan_cache.hits`` > 0, ``launch.replans`` = 0), frames
   identical; (d) ``DELPHI_COMPILE_CACHE_DIR`` at phase 2's build: the
   library's load counts one request and one hit;
   4m. the row-shard plane (slice 11): two rank processes of this script
   (``--shard-rank R``) join a gloo group on localhost with
   ``DELPHI_SHARD=1`` and ``DELPHI_MESH=off``, both on the one card, each
   with its own time limit: (a) 4's 1M table at 4's options: both ranks'
   frames equal 4's, each rank merges and none degrades, K1, K2's
   owned-segment launch and K5 launch on each rank; per rank the wall,
   phase walls, ``shard.rows``, ``launch.phase.*`` counts and the bytes it
   sent through the merges (the two ranks share the card, so the wall is
   contention, not scaling); (b) 4l(c)'s 200,000-row table twice with a
   plan store per rank: the warm run replans nothing and hits the store,
   frames equal 4l(c)'s; (c) the same table under
   ``1:shard.freq.merge:1:rank_death``: rank 1 exits 17, rank 0 exits 0
   with 4l(c)'s frame, counts the rank loss and the single-host latch,
   degrades a merge and writes ``rank_loss.json``; (d) K2's owned-segment
   launch over each rank's pairs bitwise equal to the full launch on 4's
   and 4f's buffers, the int64 sum of K1 over two half spans equal to the
   full table's, 4's K5 weak-label launch split by group owner equal to
   the full launch; each rank's recorded K1, K2 and K5 inputs held against
   the plain versions and timed (paths ``shard r0`` / ``shard r1``, and
   the ``entropy_terms_owned`` entry of the kernels line); the warm run of
   (b) writes a run report per rank (``DELPHI_METRICS_PATH``), and rank
   0's holds both ranks under ``per_process`` with summed counters;
   4o. the device mesh (slice 13): two rank processes of this script
   (``--shard-rank R``, 4m's time limits and rendezvous) join a gloo
   group with no ``DELPHI_MESH``, so the default mesh spans both ranks,
   both on the one card: (a) 4's 1M table at 4's options: both ranks'
   frames equal, K1 over each rank's block of rows, K2 on the summed
   counts and K5's integer mode over each rank's block of cells launched
   on each rank, no fault; the error cells equal 4's exactly and at most
   2% of the repairs differ from 4's (the JAX package's own bound); per
   rank the wall, phase walls, mesh reductions and the bytes and seconds
   they took; (b) 20,000 rows on the same card cluster and on a two-rank
   cluster on the CPU: the frames equal; (c) one process with
   ``DELPHI_MESH=1`` (a one-slot mesh) on 4l(c)'s 200,000-row table: 4l(c)'s
   frame; (d) each rank's recorded K1, K2 and K5 inputs held against the
   plain versions and timed (paths ``mesh r0`` / ``mesh r1`` of the
   kernels line, device time from 6's profiler session);
   4p. process-local tables (slice 14): 4's 1M dirty table is written to a
   CSV, and two rank processes of this script (4m's harness, the default
   mesh) read it through ``read_csv_encoded_sharded`` (chunks of 100,000,
   ``dtype=str``), each holding only its chunks (``process_local``, fewer
   than 1,000,000 rows), and repair it at 4's options with the NULL
   detector: (a) the union of the ranks' error cells equals one
   ``read_csv_encoded`` run of the same CSV on the card, at most 5% of the
   repairs differ (the JAX package's own bound), K1 over each rank's local
   rows and K2 on the global counts launched on each rank and held against
   their plain versions (paths ``process-local r0`` / ``r1`` of the
   kernels line), no payload of any gather holds a CUDA tensor; per rank
   the wall, the ingestion's seconds, the seconds and bytes of the
   ingestion, training-sample and model gathers, and the domain span;
   (b) 4f's ``fd_table`` cut to 200,000 rows, process-local, detect-only
   with 4f's NULL, regex, constraint and outlier detectors (the sharded DC
   statistics and the gathered outlier fences): the union of the ranks'
   detections equals the one-process run's exactly;
   4q. the live plane (slice 14): 4's 1M repair once more with
   ``DELPHI_METRICS_PORT=0``, ``DELPHI_STALL_TIMEOUT_S=60`` and
   ``DELPHI_RESOURCE_SAMPLE_S=0.5``; a thread scrapes ``/healthz``,
   ``/metrics`` and ``/report`` while the run is in flight; the frame
   equals 4's, ``device.<i>.bytes_in_use`` is above 0,
   ``watchdog.stalls`` is 0 and every plane thread has been joined when
   the run returns; its wall prints beside 4's;
   4r. the serving plane (slice 15): three seeded 100,000-row
   ``missing_heavy`` tables (A, B, C) posted as JSON with 4's options to a
   ``RepairServer(workers=2)`` in this process: (1) A cold, alone (traced
   as path "served"): its frame equals an in-process ``run()`` of A,
   sorted by all columns and put through ``to_json``, byte for byte; its
   wall against ``run()``'s, split into the client's JSON, the HTTP round
   trip, the queue, the fingerprint and encode, the run's phases and the
   response's sort and encode; (2) A warm: once resuming its phase
   checkpoints, and once without them (path "served warm": a table-cache,
   model-checkpoint and plan-store hit, no replan); (3) A, its warm state
   dropped, beside B under ``xfer.upload:1:transient,domain.bucket:1:fatal``
   (path "served concurrent"): A's frame equals (1)'s, B answers a
   structured 500 of kind ``fatal`` and only B's state is evicted; (4) C
   under the three-OOM plan: the CPU rung is refused (D1), a 500 of kind
   ``oom``, ``resilience.degrade.cpu_refused`` moves; (5) B and C clean,
   4s's references; (6) ``/healthz`` and ``/metrics`` scraped, then the
   drain, every admitted request answered. K1, K2 and K5 launch inside the
   served requests (their launches per served path print and ride the
   kernels line), and 4b holds them against their plain versions on
   those requests' inputs;
   4s. the fleet (slice 15): ``FleetRouter(workers=2)`` spawns two port
   workers (``python -m delphi_tpu_torch.main --serve``) on the one card,
   loading phase 2's library, with the autoscaler polling them (bounded
   to two workers: its events print, no scale is required); six requests
   over 4r's three tables, two first, then the first request of the table
   homed on worker 1 under ``1:xfer.upload:1:rank_death`` beside a clean
   one, then two more: every
   request answers 4r's frame, the victim exits 17, ``fleet.evictions``
   and ``fleet.redispatches`` are at least 1 and ``/healthz`` reads
   ``degraded``; each worker's spawn-to-registration seconds, the request
   walls, the card memory the workers hold (``torch.cuda.mem_get_info``,
   contexts included) and each worker's allocator and ``compile_cache``
   gauges from its ``/metrics`` print;
   4t. the gauntlet (slice 16): (a) the five scenarios at 2,000 rows.
   Where scikit-learn imports: ``python -m delphi_tpu_torch.main
   --gauntlet --metrics-out R1`` exits 0 with five scenario lines, its
   report's ``gauntlet`` section has five scored scenarios, mean F1
   above 0 and some recall above 0.5 and passes the per-scenario drift
   gate against R1, and ``--gauntlet-no-repairs --baseline-report R1
   --drift-fail-over 0.25`` exits 3. Without scikit-learn (the downstream
   triple fits its trees): ``runner.run_gauntlet`` in this process with
   only ``runner.downstream_score`` replaced by a null triple
   (:class:`downstream_or_null`), the same checks on its section, the
   gate tripping on the section of a run without repairs,
   and the CLI failing loudly, naming sklearn. (b) each scenario at the
   top of its scale series (100,000 rows; ``wide`` 50,000) as the main
   path "gauntlet" (counts zeroed just before, read just after; K5 in its
   integer mode, a ledger run): per scenario the wall, phase walls, F1,
   precision, recall, ``gap_closed`` (null without scikit-learn) and the
   K1, K2 and K5 launches; across 4t each of the three launches at least
   once, and 4b holds them against their plain versions on this path's
   inputs;
   4u. sustained load (slice 16): ``delphi_tpu_torch.observability.load``
   at the shape of the JAX package's load smoke (60 requests over 8
   ``fd_categorical`` fingerprints of 24 rows, 6 rps with a 5x spike,
   zipf 1.1, batch / incremental / stream 0.7 / 0.15 / 0.15, two retries,
   seed 17) against two spawned port workers on the card (one repair
   thread, a queue of 8), the autoscaler armed (2 to 3 workers, queue
   depth 2 for two 0.25 s ticks, a 3,600 s cooldown), the original worker
   1 killed at the ``post_kill`` boundary (:func:`load_run`); the ten
   checks of the JAX package's smoke (:func:`load_checks`: accounting
   ``sent == answered + shed + gave_up``, every segment bucketed, mixed
   fingerprints and kinds, latencies, worker attribution, the autoscaler
   up exactly once, the kill, the SLO gate passing itself and tripping on
   a degraded baseline); qps, p50, p99, shed rate, warm-hit ratio, the
   autoscale events and the recovery section print;
   4n. the run report (slice 12), run right after 4, and its profiled run
   again late, after 5 (:func:`late_profile_check`): 4's
   table at 4's options (4's run is the wall without
   the report) with ``DELPHI_METRICS_PATH``, with it and
   ``DELPHI_PROFILE_DIR`` (the main
   path, traced as "report": counts zeroed just before, K1, K2 and K5
   launched), and with ``DELPHI_PLAN_COST=1``; every frame equals 4's; the
   profiled run's report loads with status "ok", holds the JAX package's
   phases, and its ``device_time`` is complete (the profile's primer,
   ``utils/profiling.py``, kept a record) and credits device seconds to
   "attr stats" and "cell domain analysis", K1 and K2 inside the first and
   K5 inside the second (from the run's own profiler records); the late
   run is held to the same checks of its report; it prints the four
   walls (4's among them), ``device_busy_s`` and the device idle share (1 - busy / the root
   span's wall), the per-phase device seconds and top kernels, the
   report's and the trace's bytes and the launch-cost ledger's buckets;

   ``python3 chip_smoke.py --gbdt-ab PARENT N`` runs phase 1, then the
   1M NULL run, 4r's 100,000-row table and 4e's rounds of this tree
   against a ``git archive`` copy of the parent at PARENT, N times in
   each of four processes, parent, change, change, parent
   (:func:`parent_ab`: walls, training spans, ms per round, equal
   frames); ``--logreg-ab PARENT N`` the same for 4d's warm gather fit
   (seconds, steps and ms a step, equal weights);
   ``python3 chip_smoke.py --gbdt-probe [-DNAME ...] [--parent DIR]``
   builds the kernels (with those macros; ``-DDELPHI_GBDT_PHASE_CLOCKS``
   adds K3a's per-phase clocks) and times K3a, K3b, K3c and K4
   (:func:`gbdt_probe`) at 4e's shapes, the gauntlet's width, a skewed
   bin, the main path's and the constraints run's predictions, and on the
   heaviest calls of phase 4's 1M repair, 4f's 1M constraints run and the
   gauntlet's ``wide`` scenario at the top of its scale series, each held
   bitwise
   first: kernel ms, the device time from ``torch.profiler`` (L2 flushed,
   and back to back), ``index_add_``, the bounds, the empty kernel's
   floor, K3a's order floor (longest chain times one add's latency, from
   ``delphi_add_chain``); ``--parent DIR`` times the same K3c / K4 calls
   through DIR's ``csrc/gbdt.cu`` built alone (a ``git archive`` copy of
   the parent);
   ``python3 chip_smoke.py --logreg-probe [--parent DIR]`` builds the
   kernels and times K10a, K10b and K10c (:func:`logreg_probe`) at 4d's
   first step (the zones table's 10,000-row sample) and at every
   ``LOGREG_EDGES`` shape, each call held bitwise first: bare launches
   and ``torch.profiler`` device times (L2 flushed, and back to back),
   the bounds, the empty kernel's floor, K10b's order floor and
   ``index_add_``;
   ``--parent DIR`` builds DIR's ``csrc/linear.cu`` alone (a ``git
   archive`` copy of the parent) and holds and times its K10a and K10b on
   the same inputs in turns (parent, change, change, parent);
   ``python3 chip_smoke.py --ab N`` runs phases 1 and 2, then N
   same-host pairs of 4l(a) and of 4l(b) in alternating order
   (:func:`planes_ab`), and prints their walls and spans with median and
   spread instead of the kernels line; ``python3 chip_smoke.py
   --domain-ab PARENT N`` runs phase 1, then the domain phase of this tree
   against a ``git archive`` copy of the parent commit at PARENT
   (:func:`parent_ab`); ``python3 chip_smoke.py --profile-probe`` runs
   phase 1, then :func:`profile_probe` (bare and primed profiler sessions
   of spaced launches: which lose their first launches' records);

5. cross-check at default options, 20,000 rows, CPU (plain versions)
   against card (kernels): identical ``missing_heavy`` repair frames; on
   the 40-class table, every repair whose CPU top-two probability gap
   exceeds 1e-4 identical (the others counted); no target a PoorModel on
   the card only;
6. kernel device times: one ``torch.profiler`` session over every call
   timed above, last, so that no other timing follows a profiling
   session; each row's calls run inside a ``record_function`` range, and
   the kernel records are joined to the rows launch by launch through
   ``delphi_tpu_torch/utils/profiling.py`` (the run report's join); the
   count of rows that still fall back to bare launches is printed.

Every kernel timing reports the wrapper call's CUDA-event time (``ms``,
what the main path pays), the kernel's own device time from
``torch.profiler`` kernel records over the same calls (``kernel_ms``, with
the count of records beside it; CUDA events around back-to-back bare
ctypes launches where the profiler kept fewer or more records than
launches, or a time below the bound), the host's enqueue time
(``host_ms``), an empty kernel
behind the same ctypes path (``launch_floor_ms``), the bound, the plain
version and one library call.

The last lines are a ``{"kernels": [...], "pytorch_programs": [...]}``
JSON line (the hand kernels K1, K2 and K5, one entry for each of K5's
modes, the integer mode's numbers from its main path, the escalation run;
K3's three kernels and K4, each with the numbers of its heaviest recorded
call of the main path and every recorded call under ``calls``; and K8,
which is plain PyTorch; K10's three kernels, each with the numbers of
its heaviest recorded call of 4d's path, the edges and 4d's fit),
the ``nvidia-smi`` name and power limit, and the result line
``{"ok": true, "device": {...}}``.
"""

import json
import os
import statistics
import subprocess
import sys
import threading
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (NVIDIA data sheet): HBM3 rate, and the FP64
# rate outside the tensor cores for the f64 entropy arithmetic.
HBM_BYTES_PER_S = 3.35e12
FP64_OPS_PER_S = 34e12
# and the FP32 rate outside the tensor cores, for the GBDT kernels' sums
FP32_OPS_PER_S = 67e12
# and the INT32 rate, for the compares and child indices of K3c and K4:
# 64 INT32 lanes an SM (NVIDIA Hopper architecture white paper) x 132 SMs
# x the 1.98 GHz boost clock of the H100 SXM data sheet
INT32_OPS_PER_S = 64 * 132 * 1.98e9
# integer operations a node visit of K3c / K4: the compare, the child index
GBDT_OPS_PER_VISIT = 2
# f64 operations per nonzero count in K2: divide, log2, multiply, add
K2_OPS_PER_NONZERO = 4

E2E_ROWS = 1_000_000
LOGISTIC_ROWS = 200_000
CHECK_ROWS = 20_000
NULL_RATE = 0.22
MIN_ACCURACY = 0.85
# Classes of the logistic-head table's target (more than the GBDT's 24)
ZONES = 40
# With the default cap of 3 correlates per target, the 22% NULLs make
# every pair of this 5-column table fail candidate pruning, and phase 1
# would count no pairs at all; 4 keeps every candidate. Every other option
# is the default: the CV grid search runs for every GBDT target.
RUN_OPTIONS = {"error.max_attrs_to_compute_pairwise_stats": "4"}
# top-two probability gap above which the card's and the CPU's logistic
# repairs must agree
NEAR_TIE = 1e-4
# The constraints path: an fd_categorical-shaped table (fd_table) repaired
# with NULL, regex, denial-constraint and outlier detectors
DC_ROWS = 1_000_000
DC_SUITE_ROWS = 200_000
DC_TYPO_RATE, DC_NULL_RATE, DC_FD_RATE, DC_OUTLIER_RATE = 0.02, 0.03, 0.02, 0.01
DC_TARGETS = ["state", "region", "amount"]
# least share of right repairs when the injected cells are given
DC_MIN_PRECISION = 0.9
DC_CONSTRAINTS = ('city->state;state->region;'
                  't1&EQ(t1.state,"state_00")&IQ(t1.region,"region_0")')
# 4g's and 4h's tables were 1,000,000 rows at first; the script then ran
# past 480 s (PERF.md §4), so those runs were cut to 200,000 rows.
# 4g: rule repairs on fd_table, with the regex and nearest-value rules on
# (an option string turns a rule off when non-empty)
RULES_ROWS = 200_000
RULES_TARGETS = ["state", "region"]
RULES_CONSTRAINTS = "city->state;state->region"
RULES_ON = {"model.rule.repair_by_regex.disabled": "",
            "model.rule.repair_by_nearest_values.disabled": ""}
# 4g: the PMF, score and maximal-likelihood modes on missing_heavy, whole
# and in blocks of PMF_CHUNK_ROWS dirty rows. Its eight runs took about 62
# s at 200,000 rows, and with 4j the script ran past 480 s (PERF.md §4),
# so they run 100,000 rows.
PMF_ROWS = 100_000
PMF_CHUNK_ROWS = 25_000
# repairs the maximal-likelihood mode keeps per PMF_ROWS rows (it must not
# exceed the error cells: the percentile would leave [0, 100])
PMF_DELTA = 10_000
PMF_MODES = ["compute_repair_candidate_prob", "compute_repair_prob",
             "compute_repair_score", "maximal_likelihood_repair"]
# the CPU tests' tolerance on PMF probabilities
PROB_TOL = 1e-4
# 4h: the dependency graph, input splitting (k clusters) and the CLI
DEPGRAPH_ROWS = 200_000
SPLIT_ROWS = 200_000
SPLIT_K = 4
# 4h(c)'s CLI ran 200,000 rows at first; with 4j the script ran past
# 480 s (PERF.md §4), so it runs 100,000
CLI_ROWS = 100_000
# The CPU halves of 4f(d) and 4g(c) (20,000 rows) and of 4h(b) (200,000
# rows) took much of the script's time (PERF.md §4), so they were cut; the
# card side of 4h(b) stays at SPLIT_ROWS. Slice 9 moved 4f(d), 4g(c) and
# 4i(c) (CPU against card) into card tests (tests/test_torch_cuda.py), at
# CHECK_2K_ROWS rows, to pay for 4l.
SPLIT_CHECK_ROWS = 50_000
CHECK_2K_ROWS = 2_000
# The traced paths that run with a provenance ledger, where K5 takes its
# integer mode (the ledger records each cell's domain size); every other
# path that scores cells takes its weak-label mode.
K5_INT_PATHS = ("escalation", "incremental", "resilience", "gauntlet")
# K3 (the tree builder's three level kernels) and K4 (the predictor)
GBDT_KERNELS = ("gbdt_hist", "gbdt_split", "gbdt_route", "gbdt_predict")
# the traced paths that train and apply a GBDT (4d trains only the
# logistic head): each must launch all four
GBDT_PATHS = ("e2e", "report", "batched", "constraints", "served",
              "gauntlet")
# the path whose heaviest K3 / K4 calls give the kernels line its times
GBDT_MAIN_PATH = "e2e"
# the axis of a K3 / K4 argument that runs over the rows: gbdt_key leaves
# its length out
GBDT_ROW_AXIS = {"vals": 1, "node": 1, "bins": -2}
# K3a and K3b at their edges (4b, gbdt_edges): (T, per_round, n, d, n_bins,
# C, level, kind), as tests/test_torch_cuda.py's GBDT_SHAPES past 4e's
# two: about 80% of the rows in one bin ("skew", the order floor's case,
# also at 200,000 rows), one bin (every gain -inf), 16, 17 and 256 bins,
# a node without rows ("empty"), n below a window of node ids (1,024) and
# one past whole rounds of staged rows (2,048), 55 and 9 features (K3b's
# chunks of eight features, the last partial), every C, -0.0 / +inf / -inf
# / NaN values ("special": NaN gains); a duplicate column everywhere
# (equal gains across features)
GBDT_EDGES = [(24, 8, 10_000, 4, 64, 3, 0, "skew"),
              (24, 8, 10_000, 4, 64, 3, 4, "skew"),
              (3, 1, 20_000, 3, 64, 4, 0, "skew"),
              (24, 8, 200_000, 4, 64, 3, 0, "skew"),
              (4, 1, 3000, 3, 1, 1, 1, "empty"),
              (8, 1, 4097, 5, 17, 4, 3, "empty"),
              (4, 2, 700, 3, 16, 2, 2, ""),
              (2, 1, 2049, 2, 256, 3, 1, "special"),
              (6, 3, 1500, 2, 64, 1, 3, "special"),
              (24, 4, 5000, 55, 64, 3, 2, ""),
              (16, 16, 3000, 9, 64, 2, 4, "")]
# K3c at its edges (4b, gbdt_route_edges): (T, per_round, n, d, n_bins,
# level, bins layout, kind). Layouts: "models" [T / per_round, n, d] (tree
# t reads model t // per_round), "shared" [n, d], "one" [1, n, d]. Levels
# 0 (node ids None and zeros), 1 to 6; n below a block of 256 rows and
# past it; 1 to 9 and 55 features; 72 one-tree models (the batched fits)
# and 12 trees of three models (the constraints run's fits); kinds: ""
# bins in [0, n_bins) and thresholds in [0, n_bins] (the sentinel among
# them), "wide" bins and thresholds from -3 to 70,000
GBDT_ROUTE_EDGES = [(24, 8, 10_000, 4, 64, 0, "models", ""),
                    (24, 8, 10_000, 4, 64, 4, "models", ""),
                    (8, 1, 100, 3, 16, 6, "shared", ""),
                    (24, 4, 257, 55, 64, 2, "models", ""),
                    (8, 8, 5000, 8, 256, 6, "one", ""),
                    (4, 4, 600, 9, 64, 5, "shared", ""),
                    (72, 1, 1000, 4, 64, 3, "models", ""),
                    (12, 4, 700, 4, 64, 2, "models", ""),
                    (4, 2, 1000, 3, 64, 3, "models", "wide"),
                    (6, 6, 700, 55, 64, 1, "models", "wide"),
                    (1, 1, 1, 1, 2, 0, "shared", "")]
# K4 at its edges (4b, gbdt_route_edges too): (objective, T, R, depth, d, n,
# n_bins, kind): depths 1, 3, 5 and 7; 1, 25 and 300 rounds (300 past one
# staged chunk at every depth); 1 and 24 class trees; 1, 4 and 55 features
# and the widest the wrapper admits (ops/kernels/gbdt.py
# PREDICT_MAX_FEATURES, 1,024); 1, 255, 257, 1,000, 4,099, 220,000 and
# 1,000,000 rows; 256 bins (the most the binner's codes take: bins up to
# 255) at four features (the rows' bins as bytes in a register) and at 9
# and 55 (the bins staged as 16-bit words). Kinds: "" thresholds in [0,
# n_bins], "thr" only 0, n_bins - 1 and the sentinel n_bins, "special"
# about 1% of the leaves -0.0, +inf, -inf or NaN
GBDT_PREDICT_EDGES = [("regression", 1, 1, 1, 1, 1, 64, ""),
                      ("multiclass", 24, 25, 5, 4, 220_000, 64, ""),
                      ("multiclass", 8, 300, 7, 55, 257, 256, "thr"),
                      ("binary", 1, 300, 3, 4, 1_000_000, 64, ""),
                      ("multiclass", 24, 25, 7, 1024, 255, 32, "special"),
                      ("multiclass", 4, 50, 3, 55, 10_000, 64, "special"),
                      ("regression", 1, 25, 5, 1, 4099, 2, "thr"),
                      ("multiclass", 24, 3, 7, 4, 1_000_000, 64, "thr"),
                      ("multiclass", 3, 5, 3, 9, 1000, 256, "thr"),
                      ("multiclass", 4, 25, 5, 4, 5000, 256, "")]
# dependent f32 adds in the chain whose time gives one add's latency (the
# order floor of K3a: its longest per-bin chain times that latency)
ADD_CHAIN = 1 << 22
ADD_NS = []
# 4i: the provenance ledger on a missing_heavy run, and the escalation
# tier on escalation_table (NULL and regex detectors on c2). 4i(a) ran the
# 1M table of 4 and 4i(b) 1,000,000 rows at a budget of 131,072 at first;
# with 4j the script ran past 480 s (4i(a) alone took 49 s), so both run
# 200,000 rows, 4i(b) at 32,768, which still leaves tier B more than
# ESC_MIN_JOINT_CELLS cells (PERF.md §4)
LEDGER_ROWS = 200_000
ESC_ROWS = 200_000
ESC_BUDGET = 32_768
ESC_CHECK_ROWS = 20_000
ESC_CHECK_BUDGET = 4_096
ESC_REGEX = "^[0-9]{3}-[0-9]{2}$"
# least cells the joint tier (tier B, K8) must take in 4i(b)
ESC_MIN_JOINT_CELLS = 4_096
# tolerance on ledger confidences and top-k probabilities, CPU against card
LEDGER_TOL = 1e-5
# the JSONL envelope header of a provenance ledger file
LEDGER_HEADER = b"#DELPHI-STORE v1 provenance "
# 4j: incremental and streaming repair on incremental_table (the JAX
# package's bench._incremental_frames, rebuilt with numpy): a base table,
# then INC_APPEND rows appended in groups 0-3; NULL and constraint
# detectors. At 1,000,000 + 100,000 rows the script took 534.3 s, past its
# 480 s (PERF.md §7), so 4j(a) runs 200,000 + 20,000 rows (it prints the
# size that ran).
INC_ROWS = 200_000
INC_APPEND = 20_000
INC_CONSTRAINTS = "t1&t2&EQ(t1.c0,t2.c0)&IQ(t1.c3,t2.c3)"
INC_CHECK_ROWS = 20_000
# the update delta of (b) rewrites c2 in the second snapshot block
INC_UPDATE_ROWS = (4_096, 8_192)
# (c): the CLI's --stream over a table shaped like bench._stream_frames
STREAM_ROWS = 200_000
STREAM_CHUNKS = 4
# 4k: the resilience plane. (a) runs on 4's 1M table; (b) and (e) on
# RES_ROWS rows; (c) and (d) on RES_CHECK_ROWS rows, (d) with one GBDT
# config per target (the CPU half's CV grid would dominate the phase)
RES_ROWS = 200_000
RES_CHECK_ROWS = 20_000
RES_CHECK_OPTIONS = {"model.hp.max_evals": "1"}
PLAN_FATAL = "gbdt.*:1:fatal"
PLAN_RETRY = "freq.pairs_pallas:1:oom"
PLAN_LADDER = ("freq.pairs_pallas:1:oom,freq.pairs_pallas:2:oom,"
               "freq.pairs_pallas:3:oom")
PLAN_CRASH = "store.checkpoint:1:crash"
# 4l: the planes of slice 9. (a) reruns 4's 1M table with the pipeline
# off; (b) runs fd_table at BUCKET_ROWS rows under the bucketed domain
# route and under DELPHI_DEVICE_TABLE=0; (c) runs a PLAN_ROWS-row
# missing_heavy table twice at one GBDT config per target with a plan
# store (a CV search persists one `gbdt.cv[0]` plan per target under one
# key, as in the JAX package, so CV runs replan on a warm store). The
# first run of the script (566 s on one H100) ran (a) twice and (b) and (c)
# at default options on 1M rows; they were cut to these sizes
BUCKET_ROWS = 200_000
PLAN_ROWS = 200_000
PLAN_OPTIONS = {"model.hp.max_evals": "1"}
# the 1M missing_heavy run's wall before the guarded seam existed (one
# NVIDIA H100 80GB HBM3 at 700 W), beside which 4 prints its own
PRE_SEAM_E2E_WALL_S = 5.584


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def missing_heavy(n: int, seed: int):
    """(clean, dirty) frames in the shape of the gauntlet's missing_heavy
    scenario: tier, band and grade are functions of a latent level (grade
    also of the segment), and NULL_RATE of each of those three columns'
    cells are blanked."""
    import pandas as pd
    rng = np.random.RandomState(seed)
    level = rng.randint(0, 10, size=n)
    seg = rng.randint(0, 4, size=n)

    def names(fmt, k, idx):
        return np.array([fmt.format(i) for i in range(k)], dtype=object)[idx]

    clean = pd.DataFrame({
        "tid": np.arange(n, dtype=np.int64),
        "level": names("lv{}", 10, level),
        "tier": names("t{}", 5, level // 2),
        "band": names("b{}", 5, level % 5),
        "grade": names("gr{}", 6, (level + seg) % 6),
        "segment": names("s{}", 4, seg),
    })
    dirty = clean.copy()
    for col in ("tier", "band", "grade"):
        rows = rng.choice(n, int(round(NULL_RATE * n)), replace=False)
        values = dirty[col].to_numpy(dtype=object).copy()
        values[rows] = None
        dirty[col] = values
    return clean, dirty


def zones_table(n: int, seed: int):
    """(clean, dirty) frames whose one NULL-bearing column, zone, has ZONES
    classes (the logistic head's range): zone is a latent value, district
    its half and parity its last bit, amount a noisy multiple, channel
    noise; NULL_RATE of the zone cells are blanked."""
    import pandas as pd
    rng = np.random.RandomState(seed)
    latent = rng.randint(0, ZONES, size=n)

    def names(fmt, k, idx):
        return np.array([fmt.format(i) for i in range(k)], dtype=object)[idx]

    clean = pd.DataFrame({
        "tid": np.arange(n, dtype=np.int64),
        "zone": names("z{}", ZONES, latent),
        "district": names("d{}", ZONES // 2, latent // 2),
        "parity": names("p{}", 2, latent % 2),
        "channel": names("c{}", 3, rng.randint(0, 3, size=n)),
        "amount": np.round(latent * 10.0 + rng.normal(0, 4.0, size=n), 2),
    })
    dirty = clean.copy()
    values = dirty["zone"].to_numpy(dtype=object).copy()
    values[rng.choice(n, int(round(NULL_RATE * n)), replace=False)] = None
    dirty["zone"] = values
    return clean, dirty


def fd_table(n: int, seed: int):
    """(clean, dirty, truth) in the shape of the gauntlet's fd_categorical
    scenario: city (24 values) -> state = city % 12 -> region = state % 4,
    a channel (3 values) and an amount that depends on the channel.
    Disjoint cells are corrupted: DC_TYPO_RATE of the state cells get one
    of three typos of their value (a transposition, a dropped "_", an "x"
    for the "a"; 48 state spellings in all, so the column stays under the
    discrete threshold at any row count), DC_NULL_RATE of the state and of
    the region cells are blanked, DC_FD_RATE of the rows get the state of
    one other city and the region of another, and DC_OUTLIER_RATE of the
    amounts are scaled far out of range. ``truth`` maps each of state,
    region and amount to the boolean mask of its corrupted cells."""
    import pandas as pd
    rng = np.random.RandomState(seed)
    city = rng.randint(0, 24, size=n)
    channel = rng.randint(0, 3, size=n)

    def names(fmt, k, idx):
        return np.array([fmt.format(i) for i in range(k)], dtype=object)[idx]

    clean = pd.DataFrame({
        "tid": np.arange(n, dtype=np.int64),
        "city": names("city_{:02d}", 24, city),
        "state": names("state_{:02d}", 12, city % 12),
        "region": names("region_{}", 4, city % 12 % 4),
        "channel": names("ch_{}", 3, channel),
        "amount": np.round(50.0 + 40.0 * channel
                           + rng.normal(0.0, 5.0, size=n), 2),
    })
    state = clean["state"].to_numpy(dtype=object).copy()
    region = clean["region"].to_numpy(dtype=object).copy()
    amount = clean["amount"].to_numpy().copy()
    truth = {a: np.zeros(n, dtype=bool) for a in ("state", "region", "amount")}
    # disjoint row blocks of one permutation: no cell is corrupted twice
    blocks = np.split(rng.permutation(n), np.cumsum([
        int(DC_TYPO_RATE * n), int(DC_NULL_RATE * n), int(DC_NULL_RATE * n),
        int(DC_FD_RATE * n)]))
    i = blocks[0]
    typos = np.array([[f"tsate_{k:02d}", f"state{k:02d}", f"stxte_{k:02d}"]
                      for k in range(12)], dtype=object)
    state[i] = typos[city[i] % 12, rng.randint(3, size=len(i))]
    truth["state"][i] = True
    for col, attr, i in ((state, "state", blocks[1]),
                         (region, "region", blocks[2])):
        col[i] = None
        truth[attr][i] = True
    i = blocks[3]
    for col, attr, fmt, k, mod in ((state, "state", "state_{:02d}", 12, 12),
                                   (region, "region", "region_{}", 4, 4)):
        other = (city[i] + rng.randint(1, 24, size=len(i))) % 24
        vals = names(fmt, k, other % 12 % mod)
        moved = vals != col[i]
        col[i[moved]] = vals[moved]
        truth[attr][i[moved]] = True
    i = rng.choice(n, int(DC_OUTLIER_RATE * n), replace=False)
    factor = np.array([13.0, -11.0, 47.0, 101.0])[rng.randint(4, size=len(i))]
    shift = np.abs(amount).max() * np.where(factor > 0, 3.0, -3.0)
    amount[i] = np.round(amount[i] * factor + shift, 2)
    truth["amount"][i] = True
    dirty = clean.assign(state=state, region=region, amount=amount)
    return clean, dirty, truth


def dc_detectors(T) -> list:
    """The constraints path's NULL, regex, constraint and outlier
    detectors."""
    return [T.NullErrorDetector(),
            T.RegExErrorDetector("state", "^state_[0-9]{2}$"),
            T.ConstraintErrorDetector(constraints=DC_CONSTRAINTS),
            T.GaussianOutlierErrorDetector()]


def dc_model(T, df, detectors=True):
    """The constraints path's repair model: DC_TARGETS, with the NULL,
    regex, constraint and outlier detectors (or, with ``detectors``
    False, the default detector set)."""
    m = T.delphi.repair.setInput(df).setRowId("tid").setTargets(DC_TARGETS)
    if detectors:
        m = m.setErrorDetectors(dc_detectors(T))
    return m


def truth_cells(truth):
    """The corrupted (tid, attribute) cells, as setErrorCells takes them."""
    import pandas as pd
    return pd.concat([pd.DataFrame({"tid": np.flatnonzero(m),
                                    "attribute": a})
                      for a, m in truth.items()], ignore_index=True)


def dc_scores(clean, truth, out) -> dict:
    """Cell precision and recall of a repair frame against the injected
    cells: a repair is right when it equals the clean value (numbers
    within 20% or 0.5, the gauntlet's rule)."""
    tids = out["tid"].to_numpy().astype(np.int64)
    attrs = out["attribute"].to_numpy(dtype=object)
    rep = out["repaired"].to_numpy(dtype=object)
    right = np.zeros(len(out), dtype=bool)
    for a in np.unique(attrs):
        sel = np.flatnonzero(attrs == a)
        want = clean[a].to_numpy()[tids[sel]]
        hit = truth[a][tids[sel]]
        if a == "amount":
            got = np.array([float(v) if v is not None else np.nan
                            for v in rep[sel]])
            close = np.abs(got - want) <= np.maximum(0.2 * np.abs(want), 0.5)
        else:
            close = rep[sel].astype(str) == want.astype(str)
        right[sel] = hit & close
    injected = int(sum(m.sum() for m in truth.values()))
    return {"repairs": len(out), "right": int(right.sum()),
            "precision": float(right.mean()) if len(out) else 0.0,
            "recall": float(right.sum() / injected), "injected": injected}


def near_ties(T):
    """Wraps the port's ``RepairModel._repair`` to record the (tid,
    attribute) cells whose logistic-head top-two probability gap is under
    NEAR_TIE; returns (that set, restore function)."""
    from delphi_tpu_torch.model import RepairModel
    from delphi_tpu_torch.models.linear import LogisticRegressionModel
    ties, orig = set(), RepairModel._repair

    def repair(self, models, continuous_columns, dirty_rows_df, *args):
        for y, (m, features, transformers) in models:
            if not isinstance(m, LogisticRegressionModel):
                continue
            miss = dirty_rows_df[y].isna().to_numpy()
            if miss.any():
                X = self._encode_features(transformers,
                                          dirty_rows_df[features][miss])
                p = np.sort(np.asarray(m.predict_proba(X)), axis=1)
                rid = dirty_rows_df["tid"].to_numpy()[miss]
                ties.update((int(r), y)
                            for r in rid[p[:, -1] - p[:, -2] < NEAR_TIE])
        return orig(self, models, continuous_columns, dirty_rows_df, *args)

    RepairModel._repair = repair

    def restore():
        RepairModel._repair = orig
    return ties, restore


def frames_match(label, cpu, gpu, ties) -> int:
    """Fails unless the CPU and card repair frames are identical once the
    cells that differ are set aside, and every such cell is a CPU
    logistic-head near-tie. Returns how many cells differ."""
    import pandas as pd
    key = ["tid", "attribute"]
    m = cpu.merge(gpu, on=key, how="outer", suffixes=("_cpu", "_gpu"),
                  indicator=True)
    a = m["repaired_cpu"].to_numpy(dtype=object)
    b = m["repaired_gpu"].to_numpy(dtype=object)
    na, nb = pd.isna(a), pd.isna(b)
    same = (m["_merge"] == "both").to_numpy() & (
        (na & nb) | (~na & ~nb & (a.astype(str) == b.astype(str))))
    differ = {(int(t), str(x)) for t, x in m.loc[~same, key].to_numpy()}
    if not differ <= ties:
        fail(f"{label}: CPU and card repairs differ outside the logistic "
             f"near-ties: {sorted(differ - ties)[:20]}")

    def rest(frame):
        keep = [(int(t), str(x)) not in differ
                for t, x in frame[key].to_numpy()]
        return frame[keep].reset_index(drop=True)

    if not rest(cpu).equals(rest(gpu)):
        fail(f"{label}: CPU and card frames differ (order or values)")
    return len(differ)


def suite_table(n: int, seed: int):
    """A table for the constraint-route suite: zip codes in groups of
    about 12 rows, city, state, salary and rate as strings, a numeric
    score; 5% NULLs in city, state, salary and score."""
    import pandas as pd
    rng = np.random.RandomState(seed)
    df = pd.DataFrame({
        "tid": np.arange(n),
        "zip": rng.randint(0, max(n // 12, 2), n).astype(str),
        "city": rng.randint(0, 30, n).astype(str),
        "state": rng.randint(0, 8, n).astype(str),
        "salary": rng.randint(10, 99, n).astype(str),
        "rate": rng.randint(1, 50, n).astype(str),
        "score": np.round(rng.normal(50, 10, n), 1),
    })
    for c in ("city", "state", "salary", "score"):
        df.loc[rng.choice(n, n // 20, replace=False), c] = None
    return df


# every route of delphi_tpu_torch/ops/detect.py: EQ keys only, single and
# composite keys with IQ / LT / GT residuals, all-IQ inclusion-exclusion,
# mixed residuals, no EQ key, one-tuple
SUITE_CONSTRAINTS = [
    "t1&t2&EQ(t1.zip,t2.zip)&EQ(t1.state,t2.state)",
    "t1&t2&EQ(t1.zip,t2.zip)&IQ(t1.city,t2.city)",
    "t1&t2&EQ(t1.zip,t2.zip)&IQ(t1.city,t2.state)",
    "t1&t2&EQ(t1.state,t2.state)&LT(t1.salary,t2.salary)",
    "t1&t2&EQ(t1.state,t2.state)&GT(t1.rate,t2.rate)",
    "t1&t2&EQ(t1.zip,t2.zip)&EQ(t1.state,t2.state)&IQ(t1.city,t2.city)",
    "t1&t2&EQ(t1.zip,t2.zip)&EQ(t1.city,t2.city)&LT(t1.salary,t2.salary)",
    "t1&t2&EQ(t1.zip,t2.zip)&IQ(t1.city,t2.city)&IQ(t1.salary,t2.salary)",
    "t1&t2&EQ(t1.zip,t2.zip)&EQ(t1.state,t2.state)&IQ(t1.city,t2.city)"
    "&IQ(t1.rate,t2.rate)",
    "t1&t2&EQ(t1.city,t2.city)&LT(t1.score,t2.score)",
    "t1&t2&EQ(t1.zip,t2.zip)&IQ(t1.city,t2.city)&GT(t1.rate,t2.rate)",
    "t1&t2&IQ(t1.state,t2.state)&IQ(t1.zip,t2.zip)",
    't1&EQ(t1.state,"3")&IQ(t1.city,"7")',
]


def constraints_path(torch, T, traced) -> dict:
    """Phase 4f: the fd_categorical-shaped table through the NULL, regex,
    constraint and outlier detectors (see the module docstring, 4f a-e).
    Returns the path's summary."""
    from delphi_tpu_torch import constraints as dc
    from delphi_tpu_torch.ops import detect
    from delphi_tpu_torch.table import encode_table
    from delphi_tpu_torch.utils import counters

    def timed(dev, fn):
        T.set_device(dev)
        counters.clear()
        t0 = time.perf_counter()
        out = fn()
        if dev == "cuda":
            torch.cuda.synchronize()
        return out, time.perf_counter() - t0, dict(counters)

    t0 = time.perf_counter()
    clean, dirty, truth = fd_table(DC_ROWS, seed=4)
    injected = {a: int(m.sum()) for a, m in truth.items()}
    log(f"[constraints] generated {DC_ROWS} rows in "
        f"{time.perf_counter() - t0:.1f} s; injected cells {injected}")
    out = {"rows": DC_ROWS, "injected": injected}

    # (a) detect_errors_only: the card's frame equals the CPU's
    det, det_s, det_counts = timed(
        "cuda", lambda: dc_model(T, dirty).run(detect_errors_only=True))
    det_cpu, det_cpu_s, _ = timed(
        "cpu", lambda: dc_model(T, dirty).run(detect_errors_only=True))
    T.set_device("cuda")
    if not len(det) or not det.equals(det_cpu):
        fail("constraints (a): the card's detect_errors_only frame differs "
             "from the CPU's (or is empty)")
    log(f"[constraints] (a) detect_errors_only, {DC_ROWS} rows: "
        f"{len(det)} error cells, card {det_s:.3f} s, CPU {det_cpu_s:.3f} s, "
        f"frames identical; counters {json.dumps(det_counts)}")
    out["detect_only"] = {"cells": len(det), "card_s": det_s,
                          "cpu_s": det_cpu_s}

    # (b) the full run at default options, traced as a main path
    res, wall, launches, counts, walls, peak, held = traced(
        "constraints", lambda: dc_model(T, dirty).run())
    if list(res.columns) != ["tid", "attribute", "current_value",
                             "repaired"] or not len(res):
        fail(f"constraints (b): unexpected result {list(res.columns)}, "
             f"{len(res)} rows")
    flagged = set(zip(det["tid"].tolist(), det["attribute"].tolist()))
    if not all(c in flagged for c in zip(res["tid"].tolist(),
                                         res["attribute"].tolist())):
        fail("constraints (b): a repair outside the detected error cells")
    for name in ("detect.sorted_count", "detect.percentile"):
        if counts.get(name, 0) < 1:
            fail(f"constraints (b): the run made no {name} launch")
    for name, count in launches.items():
        if count < 1:
            fail(f"constraints (b): kernel {name} was not launched")
    reverted = counts.get("repair.dc_reverted", 0)
    if reverted < 1:
        fail("constraints (b): the one-tuple minimization reverted nothing")
    scores = dc_scores(clean, truth, res)
    demoted = counts.get("domain.cells_fixed", 0)
    log(f"[constraints] (b) full run, {DC_ROWS} rows: wall_s={wall:.3f} "
        f"error cells {len(det) + demoted} before demotion, {len(det)} "
        f"after; {json.dumps(scores)}; minimization reverted {reverted} "
        f"cells; launches={launches} counters={json.dumps(counts)}")
    log(f"[constraints] (b) phase walls (s): {json.dumps(walls)}; peak "
        f"device memory {peak:.1f} MiB above the {held:.1f} MiB held")
    out["run"] = {"wall_s": wall, "phase_walls": walls,
                  "domain": domain_summary("constraints", counts, walls),
                  "cells_before_demotion": len(det) + demoted,
                  "cells_after_demotion": len(det), "reverted": reverted,
                  "launches": launches, "counters": counts,
                  "peak_mib": peak, **scores}

    # (c) the default detectors, and the injected cells given by the user
    ddet, ddet_s, _ = timed("cuda", lambda: dc_model(
        T, dirty, detectors=False).run(detect_errors_only=True))
    if not len(ddet) or not set(ddet["attribute"]) <= set(DC_TARGETS):
        fail("constraints (c): default detectors found no cells (or cells "
             "outside the targets)")
    cells = truth_cells(truth)
    given, given_s, _ = timed("cuda", lambda: dc_model(
        T, dirty, detectors=False).setErrorCells(cells).run())
    given_scores = dc_scores(clean, truth, given)
    if given_scores["precision"] < DC_MIN_PRECISION:
        fail(f"constraints (c): setErrorCells repairs precision "
             f"{given_scores['precision']} below {DC_MIN_PRECISION}")
    log(f"[constraints] (c) default detectors: {len(ddet)} cells in "
        f"{ddet_s:.3f} s; setErrorCells with the {len(cells)} injected "
        f"cells: {given_s:.3f} s, {json.dumps(given_scores)}")
    out["default_detectors"] = {"cells": len(ddet), "card_s": ddet_s}
    out["error_cells"] = {"wall_s": given_s, **given_scores}

    # (d), CPU against card, is a card test at 2,000 rows: the detectors
    # run since slice 9, the default-detector and setErrorCells runs since
    # slice 8 (tests/test_torch_cuda.py::test_constraints_table_card_matches_cpu)

    # (e) every constraint route on the card against the CPU
    df = suite_table(DC_SUITE_ROWS, seed=6)
    table = encode_table(df, "tid")
    attrs = df.columns.tolist()
    suite_counts = {}
    for stmt in SUITE_CONSTRAINTS:
        parsed = dc.parse_and_verify_constraints([stmt], "suite", attrs)
        got, _, c = timed("cuda", lambda: detect.detect_constraint_violations(
            table, parsed, attrs))
        want, _, _ = timed("cpu", lambda: detect.detect_constraint_violations(
            table, parsed, attrs))
        if not got or [(a, r.tolist()) for r, a in got] \
                != [(a, r.tolist()) for r, a in want]:
            fail(f"constraints (e): {stmt} differs between CPU and card")
        for k, v in c.items():
            suite_counts[k] = suite_counts.get(k, 0) + v
    T.set_device("cuda")
    for name in ("detect.sorted_count", "detect.rank",
                 "detect.group_extrema"):
        if suite_counts.get(name, 0) < 1:
            fail(f"constraints (e): the suite made no {name} launch")
    log(f"[constraints] (e) {len(SUITE_CONSTRAINTS)} constraint routes, "
        f"{DC_SUITE_ROWS} rows: card cells identical to the CPU's; device "
        f"steps {json.dumps(suite_counts)}")
    out["suite_counters"] = suite_counts
    log(f"[constraints] summary {json.dumps(out)}")
    return out


def rules_model(T, df):
    """4g(a): NULL, regex and FD-constraint detectors with every rule
    repair on: regex structure, nearest values under a Levenshtein cost on
    state, FD rule models."""
    m = T.delphi.repair.setInput(df).setRowId("tid") \
        .setTargets(RULES_TARGETS).setErrorDetectors([
            T.NullErrorDetector(),
            T.RegExErrorDetector("state", "^state_[0-9]{2}$"),
            T.ConstraintErrorDetector(constraints=RULES_CONSTRAINTS)]) \
        .setRepairByRules(True) \
        .setUpdateCostFunction(T.Levenshtein(targets=["state"]))
    for k, v in RULES_ON.items():
        m = m.option(k, v)
    return m


def pmf_model(T, df):
    """4g(b): NULL detection on missing_heavy with a Levenshtein cost and
    a repair delta (PMF_DELTA per PMF_ROWS rows), for every PMF, score and
    maximal-likelihood mode."""
    m = T.delphi.repair.setInput(df).setRowId("tid") \
        .setErrorDetectors([T.NullErrorDetector()]) \
        .setUpdateCostFunction(T.Levenshtein()) \
        .setRepairDelta(PMF_DELTA * len(df) // PMF_ROWS)
    for k, v in RUN_OPTIONS.items():
        m = m.option(k, v)
    return m


def fd_rules_chosen(T):
    """Wraps the port's model building to record each FD rule model as
    y -> x; returns (that dict, restore function)."""
    from delphi_tpu_torch.model import FunctionalDepModel, RepairModel
    chosen, orig = {}, RepairModel._build_repair_models

    def build(self, *args, **kwargs):
        models = orig(self, *args, **kwargs)
        chosen.update({y: m.x for y, (m, _, _) in models
                       if isinstance(m, FunctionalDepModel)})
        return models

    RepairModel._build_repair_models = build

    def restore():
        RepairModel._build_repair_models = orig
    return chosen, restore


def records(frame):
    """A frame's rows as dicts with every NULL as None, for exact
    comparison across frames built by different routes."""
    return frame.astype(object).where(frame.notna(), None).to_dict("records")


def pmf_gaps_and_check(label, cpu, gpu) -> int:
    """Fails unless two candidate-PMF frames hold the same cells, classes
    and probabilities within PROB_TOL, class orders equal wherever adjacent
    CPU probabilities differ by more; returns how many cells' lists differ
    in length (on the ``P > threshold`` cut)."""
    if records(cpu[["tid", "attribute", "current_value"]]) != records(
            gpu[["tid", "attribute", "current_value"]]):
        fail(f"{label}: the CPU and card PMF frames hold different cells")
    on_cut, worst = 0, 0.0
    for c, g in zip(cpu["pmf"], gpu["pmf"]):
        if len(c) != len(g):
            on_cut += 1
            continue
        by_class = {e["class"]: e["prob"] for e in g}
        for j, e in enumerate(c):
            if e["class"] not in by_class:
                fail(f"{label}: class {e['class']} missing on the card")
            worst = max(worst, abs(by_class[e["class"]] - e["prob"]))
            if j + 1 < len(c) and e["prob"] - c[j + 1]["prob"] > PROB_TOL \
                    and {x["class"] for x in c[:j + 1]} != \
                    {x["class"] for x in g[:j + 1]}:
                fail(f"{label}: class order differs past a gap of "
                     f"{PROB_TOL}: {c} vs {g}")
    if worst > PROB_TOL:
        fail(f"{label}: PMF probabilities differ by {worst} > {PROB_TOL}")
    return on_cut


def rules_pmf_cross_check(T, rows: int) -> dict:
    """4g's CPU-against-card check (a card test since slice 9): rule
    repairs identical, PMF probabilities within PROB_TOL, scores within
    PROB_TOL and maximal-likelihood selections equal off the percentile
    cut, on ``rows`` rows."""
    t0 = time.perf_counter()
    sclean, sdirty, _ = fd_table(rows, seed=9)
    _, spdirty = missing_heavy(rows, seed=10)
    frames = {}
    for dev in ("cpu", "cuda"):
        T.set_device(dev)
        frames[dev] = {
            "rules": rules_model(T, sdirty).run(),
            "pmf": pmf_model(T, spdirty).run(
                compute_repair_candidate_prob=True),
            "score": pmf_model(T, spdirty).run(compute_repair_score=True),
            "ml": pmf_model(T, spdirty).run(maximal_likelihood_repair=True)}
    cpu, gpu = frames["cpu"], frames["cuda"]
    if not len(gpu["rules"]) or records(cpu["rules"]) != records(gpu["rules"]):
        fail("rules (c): the CPU and card rule-repair frames differ")
    on_cut = pmf_gaps_and_check("pmf (c)", cpu["pmf"], gpu["pmf"])
    w, g = cpu["score"]["score"].to_numpy(), gpu["score"]["score"].to_numpy()
    if records(cpu["score"][["tid", "attribute", "repaired"]]) != records(
            gpu["score"][["tid", "attribute", "repaired"]]) \
            or not np.allclose(w, g, rtol=PROB_TOL, atol=PROB_TOL):
        fail("pmf (c): the CPU and card scores differ")
    pct = (1.0 - (PMF_DELTA * rows // PMF_ROWS) / len(w)) * 100.0
    thres = np.percentile(w, pct)
    near = np.abs(w - thres) <= PROB_TOL * max(1.0, abs(thres))
    keys = lambda f: set(zip(f["tid"].tolist(), f["attribute"].tolist()))  # noqa: E731
    near_keys = set(zip(cpu["score"]["tid"][near].tolist(),
                        cpu["score"]["attribute"][near].tolist()))
    flipped = keys(cpu["ml"]) ^ keys(gpu["ml"])
    if not flipped <= near_keys:
        fail(f"pmf (c): maximal-likelihood selections differ off the cut: "
             f"{sorted(flipped - near_keys)[:10]}")
    T.set_device("cuda")
    out = {"rows": rows, "rules_repairs": len(gpu["rules"]),
           "pmf_cells": len(gpu["pmf"]), "pmf_on_threshold_cut": on_cut,
           "ml_cells_near_cut": int(near.sum()), "ml_flipped": len(flipped)}
    log(f"[rules-pmf] (c) {rows} rows, CPU against card: rule repairs "
        f"identical; PMF probabilities within {PROB_TOL}; "
        f"{json.dumps(out)} ({time.perf_counter() - t0:.1f} s)")
    return out


def rules_and_pmf(torch, T, traced) -> dict:
    """Phase 4g (module docstring): rule repairs, the PMF / score /
    maximal-likelihood modes whole and chunked, and a CPU cross-check."""
    from delphi_tpu_torch.utils import counters, phase_walls
    out = {}

    # (a) rule repairs on fd_table
    t0 = time.perf_counter()
    clean, dirty, truth = fd_table(RULES_ROWS, seed=7)
    truth = {a: truth[a] for a in RULES_TARGETS}
    log(f"[rules] generated {RULES_ROWS} rows in "
        f"{time.perf_counter() - t0:.1f} s")
    chosen, restore = fd_rules_chosen(T)
    try:
        res, wall, launches, counts, walls, peak, held = traced(
            "rules", lambda: rules_model(T, dirty).run())
    finally:
        restore()
    if list(res.columns) != ["tid", "attribute", "current_value",
                             "repaired"] or not len(res):
        fail(f"rules (a): unexpected result {list(res.columns)}, "
             f"{len(res)} rows")
    if counts.get("train.fd_rule_models", 0) < 1:
        fail("rules (a): no FD rule model was chosen")
    for name, count in launches.items():
        if count < 1:
            fail(f"rules (a): kernel {name} was not launched")
    scores = dc_scores(clean, truth, res)
    by_rule = {k: counts.get(f"rules.{k}", 0)
               for k in ("regex_repairs", "nearest_value_repairs")}
    log(f"[rules] (a) {RULES_ROWS} rows: wall_s={wall:.3f} FD rules "
        f"{json.dumps({y: f'{y} <- {x}' for y, x in chosen.items()})}; "
        f"repaired by rule {json.dumps(by_rule)}; {json.dumps(scores)}; "
        f"launches={launches} counters={json.dumps(counts)}")
    log(f"[rules] (a) phase walls (s): {json.dumps(walls)}; peak device "
        f"memory {peak:.1f} MiB above the {held:.1f} MiB held")
    out["rules"] = {"rows": RULES_ROWS, "wall_s": wall, "phase_walls": walls,
                    "fd_rules": chosen, "by_rule": by_rule,
                    "launches": launches, "peak_mib": peak, **scores}

    # (b) every PMF mode, whole, then in blocks of PMF_CHUNK_ROWS
    t0 = time.perf_counter()
    _, pdirty = missing_heavy(PMF_ROWS, seed=8)
    log(f"[pmf] generated {PMF_ROWS} rows in {time.perf_counter() - t0:.1f} s")
    whole, runs = {}, {}
    for i, mode in enumerate(PMF_MODES):
        if i == 0:
            frame, wall, launches, counts, walls, peak, held = traced(
                "pmf", lambda: pmf_model(T, pdirty).run(**{mode: True}))
            for name, count in launches.items():
                if count < 1:
                    fail(f"pmf (b): kernel {name} was not launched")
        else:
            phase_walls.clear()
            counters.clear()
            t0 = time.perf_counter()
            frame = pmf_model(T, pdirty).run(**{mode: True})
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            walls = {k: round(v, 3) for k, v in phase_walls.items()}
            counts = dict(counters)
        if not len(frame):
            fail(f"pmf (b): {mode} returned no rows")
        whole[mode] = frame
        runs[mode] = {"wall_s": wall, "rows": len(frame),
                      "phase_walls": walls}
        log(f"[pmf] (b) {mode}, {PMF_ROWS} rows: wall_s={wall:.3f} "
            f"rows={len(frame)} phase walls {json.dumps(walls)} "
            f"counters={json.dumps(counts)}")
    os.environ["DELPHI_REPAIR_CHUNK_ROWS"] = str(PMF_CHUNK_ROWS)
    try:
        for mode in PMF_MODES:
            counters.clear()
            t0 = time.perf_counter()
            frame = pmf_model(T, pdirty).run(**{mode: True})
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            chunks = counters.get("repair.chunks", 0)
            if chunks < 2 or records(frame) != records(whole[mode]):
                fail(f"pmf (b): {mode} in blocks of {PMF_CHUNK_ROWS} rows "
                     f"({chunks} chunks) differs from the whole block")
            runs[mode].update(chunked_wall_s=wall, chunks=chunks)
            log(f"[pmf] (b) {mode} in {chunks} chunks of {PMF_CHUNK_ROWS} "
                f"dirty rows: wall_s={wall:.3f}, frame equal to the whole "
                "block's")
    finally:
        del os.environ["DELPHI_REPAIR_CHUNK_ROWS"]
    out["pmf"] = {"rows": PMF_ROWS, "runs": runs}

    # (c), CPU against card, is a card test since slice 9
    # (tests/test_torch_cuda.py::test_rules_and_pmf_modes_card_match_cpu,
    # rules_pmf_cross_check at CHECK_2K_ROWS rows)
    log(f"[rules-pmf] summary {json.dumps(out, default=str)}")
    return out


def misc_and_cli(torch, T, traced) -> dict:
    """Phase 4h (module docstring): the dependency graph, input splitting
    and the batch CLI."""
    import tempfile

    import pandas as pd
    from delphi_tpu_torch.ops import cluster
    out = {}
    tmp = tempfile.mkdtemp(prefix="delphi_smoke_")

    def dot(name, path):
        T.delphi.misc.options({
            "table_name": name, "path": path, "edge_label": "1",
            "pairwise_attr_stat_threshold": "1.5"}).generateDepGraph()
        with open(os.path.join(path, "depgraph.dot")) as f:
            return f.read()

    # (a) the dependency graph
    _, ddirty, _ = fd_table(DEPGRAPH_ROWS, seed=11)
    T.delphi.register_table("depgraph_input", ddirty)
    text, wall, launches, _, _, peak, _ = traced(
        "depgraph", lambda: dot("depgraph_input", os.path.join(tmp, "g")))
    for name, count in launches.items():
        if count < 1:
            fail(f"depgraph (a): kernel {name} was not launched")
    _, sdirty, _ = fd_table(CHECK_ROWS, seed=12)
    T.delphi.register_table("depgraph_check", sdirty)
    texts = {}
    for dev in ("cpu", "cuda"):
        T.set_device(dev)
        texts[dev] = dot("depgraph_check", os.path.join(tmp, f"g_{dev}"))
    if texts["cpu"] != texts["cuda"] or not texts["cuda"].startswith(
            "digraph {"):
        fail("depgraph (a): the card's dot text differs from the CPU's")
    log(f"[depgraph] (a) {DEPGRAPH_ROWS} rows: wall_s={wall:.3f} "
        f"{len(text)} bytes of dot, launches={launches}, peak device "
        f"memory {peak:.1f} MiB; {CHECK_ROWS} rows: dot text identical on "
        "the CPU and the card")
    out["depgraph"] = {"rows": DEPGRAPH_ROWS, "wall_s": wall,
                       "launches": launches}

    # (b) input splitting on the card at SPLIT_ROWS rows, card against CPU
    # at SPLIT_CHECK_ROWS rows, and one Lloyd iteration
    _, split_df, _ = fd_table(SPLIT_ROWS, seed=13)
    T.delphi.register_table("split_input", split_df)
    T.delphi.register_table("split_check", split_df[:SPLIT_CHECK_ROWS])
    out["split"] = {}

    def split(dev, name, alg):
        T.set_device(dev)
        t0 = time.perf_counter()
        labels = T.delphi.misc.options({
            "table_name": name, "row_id": "tid", "k": str(SPLIT_K),
            "clustering_alg": alg}).splitInputTable()
        return labels, time.perf_counter() - t0

    for alg in ("bisect-kmeans", "kmeans++"):
        full, card_s = split("cuda", "split_input", alg)
        on_card, check_card_s = split("cuda", "split_check", alg)
        on_cpu, check_cpu_s = split("cpu", "split_check", alg)
        if not on_card.equals(on_cpu) or full["k"].nunique() != SPLIT_K \
                or on_card["k"].nunique() != SPLIT_K:
            fail(f"split (b): {alg} labels on the card differ from the "
                 "CPU's")
        sizes = full["k"].value_counts().sort_index().tolist()
        out["split"][alg] = {"card_s": card_s, "sizes": sizes,
                             "check_card_s": check_card_s,
                             "check_cpu_s": check_cpu_s}
        log(f"[split] (b) {alg}, k={SPLIT_K}: {SPLIT_ROWS} rows on the card "
            f"in {card_s:.3f} s, cluster sizes {sizes}; {SPLIT_CHECK_ROWS} "
            f"rows: labels identical on the card ({check_card_s:.3f} s) and "
            f"the CPU ({check_cpu_s:.3f} s)")
    T.set_device("cuda")
    X = torch.from_numpy(cluster.qgram_features(
        split_df.drop(columns=["tid"]), 2)).cuda()
    init = X[:2].clone()
    ms = {}
    for iters in (1, 5):
        cluster._lloyd(X, init, 2, iters)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(3):
            cluster._lloyd(X, init, 2, iters)
        end.record()
        torch.cuda.synchronize()
        ms[iters] = start.elapsed_time(end) / 3
    lloyd_ms = (ms[5] - ms[1]) / 4
    out["lloyd_iteration_ms"] = lloyd_ms
    log(f"[split] (b) one Lloyd iteration at {SPLIT_ROWS} x "
        f"{cluster.FEATURE_DIM}, k=2, on the card: {lloyd_ms:.3f} ms "
        f"(1 iteration + final assignment {ms[1]:.3f} ms)")
    del X

    # (c) the batch CLI in a subprocess against the in-process run
    _, cdirty, _ = fd_table(CLI_ROWS, seed=14)
    csv_in, dc_file = os.path.join(tmp, "in.csv"), os.path.join(tmp, "dc.txt")
    cdirty.to_csv(csv_in, index=False)
    with open(dc_file, "w") as f:
        f.write(RULES_CONSTRAINTS.replace(";", "\n") + "\n")
    csv_out = os.path.join(tmp, "out.csv")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "delphi_tpu_torch.main", "--input", csv_in,
         "--row-id", "tid", "--output", csv_out, "--constraints", dc_file],
        cwd=HERE, capture_output=True, text=True, timeout=600)
    cli_s = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"cli (c): exit {proc.returncode}: {proc.stderr[-2000:]}")
    frame = T.delphi.repair.setInput(pd.read_csv(csv_in)).setRowId("tid") \
        .setErrorDetectors([T.NullErrorDetector(), T.ConstraintErrorDetector(
            constraint_path=dc_file)]).run()
    want = os.path.join(tmp, "in_process.csv")
    frame.to_csv(want, index=False)
    with open(csv_out) as a, open(want) as b:
        if a.read() != b.read() or not len(frame):
            fail("cli (c): the CLI's CSV differs from the in-process frame")
    out["cli"] = {"rows": CLI_ROWS, "wall_s": cli_s, "repairs": len(frame)}
    log(f"[cli] (c) python -m delphi_tpu_torch.main on {CLI_ROWS} rows "
        f"with --constraints: {cli_s:.3f} s including the interpreter; CSV "
        f"({len(frame)} rows) equal to the in-process run's; "
        f"{proc.stderr.strip().splitlines()[-1]}")
    log(f"[misc-cli] summary {json.dumps(out, default=str)}")
    return out


def escalation_table(n: int):
    """(dirty, truth) in the construction of the JAX package's escalation
    fixture (``bench.py::_escalate_frames``): ``c1`` is a function of
    ``c0``; ``c2`` is an ``NNN-NN`` code whose first factor appears in no
    other column, so the models are unsure of it and its error cells
    route; separators broken to ``x`` every 13th row from 5 (pattern-tier
    repairable), NULLs in ``c1`` every 17th from 3 and in ``c2`` every 23rd
    from 7. ``truth`` maps (tid, attribute) to the clean value of every
    corrupted cell. One change: ``c2``'s factors are ``i % 3`` and
    ``i % 8`` where the fixture has ``i % 7`` and ``i % 8``. With 56 codes
    and their 56 broken spellings, the fixture's ``c2`` passes the default
    discrete threshold (80 distinct values) only below a few hundred rows
    and never fits the joint tier's 64-value domain, so at scale nothing
    routes and tier B never launches; 24 codes and 24 broken spellings fit
    both, and 24 classes keep ``c2`` on the GBDT."""
    import pandas as pd
    i = np.arange(n)
    names = lambda fmt, k: np.array(  # noqa: E731
        [fmt.format(v) for v in range(k)], dtype=object)
    codes = np.array([f"{100 + a}-{10 + b}" for a in range(3)
                      for b in range(8)], dtype=object)
    clean = pd.DataFrame({
        "tid": i.astype(str).astype(object),
        "c0": names("g{}", 8)[i % 8],
        "c1": names("v{}", 4)[(i % 8) % 4],
        "c2": codes[(i % 3) * 8 + i % 8],
    })
    dirty = clean.copy()
    c1 = dirty["c1"].to_numpy(dtype=object).copy()
    c2 = dirty["c2"].to_numpy(dtype=object).copy()
    truth = {}
    breaks = np.arange(5, n, 13)
    c2[breaks] = [v.replace("-", "x") for v in c2[breaks]]
    truth.update({(str(r), "c2"): clean["c2"].iat[r] for r in breaks})
    c1[np.arange(3, n, 17)] = None
    truth.update({(str(r), "c1"): clean["c1"].iat[r]
                  for r in range(3, n, 17)})
    c2[np.arange(7, n, 23)] = None
    truth.update({(str(r), "c2"): clean["c2"].iat[r]
                  for r in range(7, n, 23)})
    dirty["c1"], dirty["c2"] = c1, c2
    return dirty, truth


def escalation_f1(frame, truth) -> float:
    """Cell-level F1 of a repair-candidates frame against the injected
    cells (``bench.py::_escalate_f1``)."""
    by_cell = dict(zip(zip(frame["tid"].astype(str), frame["attribute"]),
                       frame["repaired"]))
    correct = sum(1 for k, v in by_cell.items() if truth.get(k) == v)
    p = correct / len(by_cell) if by_cell else 0.0
    r = correct / len(truth) if truth else 0.0
    return 2 * p * r / (p + r) if p + r else 0.0


def escalation_model(T, df, budget=None, detectors=True):
    dets = [T.NullErrorDetector()]
    if detectors:
        dets.append(T.RegExErrorDetector("c2", ESC_REGEX))
    m = T.delphi.repair.setInput(df).setRowId("tid").setErrorDetectors(dets)
    if budget is not None:
        m = m.option("repair.escalate", "true") \
            .option("repair.escalate.budget", str(budget))
    return m


class LedgerCapture:
    """Keeps the ledgers ``run()`` finalizes, and times the ledger's work
    while it is on: the per-cell record calls, the JSONL write, and the
    extra ``predict_proba`` of the plain prediction path (the time of
    ``RepairModel._record_prediction`` less the records it makes)."""

    RECORDS = ("record_detection", "record_current_values",
               "record_domain_sizes", "record_weak_label_demotions",
               "record_model_score", "record_posterior",
               "record_point_predictions", "record_pmf_topk",
               "record_decisions", "record_decision",
               "record_escalation_routed", "record_escalation")

    def __init__(self):
        from delphi_tpu_torch import model as t_model
        from delphi_tpu_torch.observability import provenance
        self.prov, self.model = provenance, t_model.RepairModel
        self.ledgers, self.seconds = [], {}
        self.saved = []

    def __enter__(self):
        prov, cls = self.prov, self.prov.ProvenanceLedger

        def timed(owner, name, key):
            orig = getattr(owner, name)
            self.saved.append((owner, name, vars(owner)[name]))

            def wrapper(*a, **k):
                t0 = time.perf_counter()
                try:
                    return orig(*a, **k)
                finally:
                    self.seconds[key] = self.seconds.get(key, 0.0) \
                        + time.perf_counter() - t0
            setattr(owner, name, staticmethod(wrapper)
                    if isinstance(owner.__dict__.get(name), staticmethod)
                    else wrapper)

        for name in self.RECORDS:
            timed(cls, name, "records")
        for name in ("record_posterior", "record_point_predictions"):
            self.saved.append((cls, name, vars(cls)[name]))

        def in_prediction(orig):
            def wrapper(*a, **k):
                t0 = time.perf_counter()
                try:
                    return orig(*a, **k)
                finally:
                    self.seconds["prediction_records"] = self.seconds.get(
                        "prediction_records", 0.0) \
                        + time.perf_counter() - t0
            return wrapper
        cls.record_posterior = in_prediction(cls.record_posterior)
        cls.record_point_predictions = in_prediction(
            cls.record_point_predictions)
        timed(cls, "write", "write")
        timed(self.model, "_record_prediction", "prediction")
        orig_finalize = prov.finalize
        self.saved.append((prov, "finalize", orig_finalize))

        def finalize(holder):
            if getattr(holder, "provenance", None) is not None:
                self.ledgers.append(holder.provenance)
            return orig_finalize(holder)
        prov.finalize = finalize
        return self

    def __exit__(self, *exc):
        for owner, name, orig in reversed(self.saved):
            setattr(owner, name, orig)
        self.saved = []

    def split(self) -> dict:
        s = self.seconds
        return {"records_s": s.get("records", 0.0),
                "write_s": s.get("write", 0.0),
                "extra_predict_proba_s": s.get("prediction", 0.0)
                - s.get("prediction_records", 0.0)}


def entries_match(label, got, want) -> None:
    """Ledger entries: every discrete field equal, confidence and top-k
    probabilities within LEDGER_TOL, top-k values equal where no other
    probability of the entry is within LEDGER_TOL."""
    if len(got) != len(want) or not want:
        fail(f"{label}: {len(got)} ledger entries against {len(want)}")
    discrete = ("row_id", "attribute", "detectors", "current_value",
                "domain_size", "decision", "decision_reason", "repaired",
                "escalation_routed", "escalation_tier")
    for g, w in zip(got, want):
        if set(g) != set(w) or any(g.get(f) != w.get(f) for f in discrete):
            fail(f"{label}: ledger entries differ: {g} against {w}")
        for f in ("confidence", "escalation_confidence"):
            if (g.get(f) is None) != (w.get(f) is None) or (
                    w.get(f) is not None
                    and abs(g[f] - w[f]) > LEDGER_TOL):
                fail(f"{label}: {f} differs: {g} against {w}")
        gk, wk = g.get("top_k") or [], w.get("top_k") or []
        if len(gk) != len(wk):
            fail(f"{label}: top-k differ: {g} against {w}")
        for i, (a, b) in enumerate(zip(gk, wk)):
            if b["prob"] is None:
                if a != b:
                    fail(f"{label}: top-k differ: {g} against {w}")
                continue
            if abs(a["prob"] - b["prob"]) > LEDGER_TOL or (
                    a["value"] != b["value"] and not any(
                        abs(b["prob"] - o["prob"]) <= LEDGER_TOL
                        for j, o in enumerate(wk) if j != i)):
                fail(f"{label}: top-k differ: {g} against {w}")


def time_k8(torch, k_joint, args) -> float:
    """CUDA-event ms of one K8 call on recorded inputs (median of 5)."""
    k_joint.joint_ascent(*args)
    out = []
    for _ in range(5):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        k_joint.joint_ascent(*args)
        end.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end))
    return statistics.median(out)


def k8_bound_ms(args) -> float:
    """Reading nbr_pot once an iteration, iters * n * K * V^2 * 4 bytes, at
    the card's memory rate."""
    _, _, pot, iters = args
    return iters * pot.numel() * 4 / HBM_BYTES_PER_S * 1e3


def escalation_cross_check(T, rows: int, budget: int) -> dict:
    """4i's CPU-against-card check (a card test since slice 9): frames,
    routed and escalated cells, budget and tiers equal, and the in-memory
    ledgers' entries within LEDGER_TOL, on ``rows`` rows of
    ``escalation_table`` at ``budget``."""
    t0 = time.perf_counter()
    sdirty, _ = escalation_table(rows)
    runs = {}
    os.environ["DELPHI_PROVENANCE_PATH"] = ":memory:"
    try:
        for dev in ("cpu", "cuda"):
            T.set_device(dev)
            m = escalation_model(T, sdirty, budget)
            with LedgerCapture() as cap:
                frame = m.run()
            runs[dev] = (frame, m._last_escalation, cap.ledgers[0].entries())
    finally:
        del os.environ["DELPHI_PROVENANCE_PATH"]
        T.set_device("cuda")
    (f_cpu, s_cpu, e_cpu), (f_gpu, s_gpu, e_gpu) = runs["cpu"], runs["cuda"]
    if not f_gpu.equals(f_cpu):
        fail("escalation (c): the card's frame differs from the CPU's")
    for key in ("routed_cells", "escalated_cells", "routed", "escalated",
                "budget", "tiers"):
        if s_gpu[key] != s_cpu[key]:
            fail(f"escalation (c): {key} differs between CPU and card")
    entries_match("escalation (c)", e_gpu, e_cpu)
    if not s_gpu["escalated"]:
        fail("escalation (c): nothing escalated")
    out = {"rows": rows, "repairs": len(f_gpu), "routed": s_gpu["routed"],
           "escalated": s_gpu["escalated"], "entries": len(e_gpu)}
    log(f"[escalation] (c) {rows} rows, budget {budget}, CPU against card: "
        f"frames, routed and escalated cells equal, ledger entries equal "
        f"within {LEDGER_TOL}: {json.dumps(out)} "
        f"({time.perf_counter() - t0:.1f} s)")
    return out


def ledger_and_escalation(torch, T, traced) -> dict:
    """Phase 4i (module docstring): the provenance ledger on a
    missing_heavy run, the escalation tier at full width, CPU against card,
    and the CLI."""
    import tempfile

    import pandas as pd
    from delphi_tpu_torch.ops import joint as k_joint
    from delphi_tpu_torch.parallel import store
    from delphi_tpu_torch.utils import counters, phase_walls
    out = {}
    tmp = tempfile.mkdtemp(prefix="delphi_smoke_")

    # (a) the ledger on a missing_heavy run at 4's options, and the same
    # run without it
    _, dirty = missing_heavy(LEDGER_ROWS, seed=0)
    n_err = int(dirty[["tier", "band", "grade"]].isna().to_numpy().sum())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain = repair(T, dirty)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    path = os.path.join(tmp, "ledger.jsonl")
    os.environ["DELPHI_PROVENANCE_PATH"] = path
    try:
        with LedgerCapture() as cap:
            t0 = time.perf_counter()
            with_ledger = repair(T, dirty)
            torch.cuda.synchronize()
            ledger_s = time.perf_counter() - t0
    finally:
        del os.environ["DELPHI_PROVENANCE_PATH"]
    if not with_ledger.equals(plain):
        fail("ledger (a): the frame with a ledger differs from the one "
             "without")
    if len(cap.ledgers) != 1:
        fail(f"ledger (a): {len(cap.ledgers)} ledgers finalized, not one")
    cells = list(cap.ledgers[0]._cells.values())
    undecided = sum(1 for e in cells if "decision" not in e)
    if len(cells) != n_err or undecided:
        fail(f"ledger (a): {len(cells)} entries for {n_err} detected cells, "
             f"{undecided} without a decision")
    rows, status = store.read_jsonl(path, schema="provenance",
                                    site="store.provenance")
    if status != "ok" or len(rows) != n_err:
        fail(f"ledger (a): the file reads back {status}")
    out["ledger"] = {"rows": LEDGER_ROWS, "entries": len(cells),
                     "wall_s": ledger_s, "plain_wall_s": plain_s,
                     "file_bytes": os.path.getsize(path), **cap.split()}
    log(f"[ledger] (a) {LEDGER_ROWS} rows missing_heavy, default options: "
        f"{json.dumps(out['ledger'])}; frame equal to the run without a "
        "ledger, one decided entry per detected cell")

    # (b) escalation at full width
    edirty, truth = escalation_table(ESC_ROWS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    off = escalation_model(T, edirty).run()
    torch.cuda.synchronize()
    off_s = time.perf_counter() - t0
    k8_calls = []
    orig_k8 = k_joint.joint_ascent

    def rec_k8(unary, nbr_idx, nbr_pot, iters):
        k8_calls.append((unary, nbr_idx, nbr_pot, iters))
        return orig_k8(unary, nbr_idx, nbr_pot, iters)

    model = escalation_model(T, edirty, ESC_BUDGET)
    k_joint.reset_launches()
    k_joint.joint_ascent = rec_k8
    try:
        on, wall, launches, counts, walls, peak, held = traced(
            "escalation", model.run)
    finally:
        k_joint.joint_ascent = orig_k8
    summary = model._last_escalation
    f1_off, f1_on = escalation_f1(off, truth), escalation_f1(on, truth)
    tiers = summary["tiers"]
    joint_cells = counts.get("escalation.joint.cells", 0)
    tier_walls = {k: v for k, v in walls.items()
                  if k.startswith("escalation.")}
    log(f"[escalation] (b) {ESC_ROWS} rows, budget {ESC_BUDGET}: wall_s="
        f"{wall:.3f} (without escalation {off_s:.3f}), escalation span "
        f"{walls.get('escalation', 0.0):.3f} s (by step: "
        f"{json.dumps(tier_walls)}); routed {summary['routed']}, "
        f"escalated {summary['escalated']}, budget "
        f"{json.dumps(summary['budget'])}, tiers {json.dumps(tiers)}; "
        f"phase walls {json.dumps(walls)}; counters {json.dumps(counts)}; "
        f"launches {launches}; peak device memory {peak:.1f} MiB above "
        f"{held:.1f} MiB; cell F1 off {f1_off:.6f}, on {f1_on:.6f}")
    for name, count in launches.items():
        if count < 1:
            fail(f"escalation (b): kernel {name} was not launched")
    if joint_cells < ESC_MIN_JOINT_CELLS or not k8_calls:
        fail(f"escalation (b): tier B took {joint_cells} cells, fewer than "
             f"{ESC_MIN_JOINT_CELLS}")
    if f1_on < f1_off:
        fail(f"escalation (b): F1 with escalation {f1_on} below {f1_off}")
    k8 = []
    for args in k8_calls:
        n_pad, v_pad = (int(d) for d in args[0].shape)
        k8.append({"n_pad": n_pad, "v_pad": v_pad, "iters": int(args[3]),
                   "ms": time_k8(torch, k_joint, args),
                   "bound_ms": k8_bound_ms(args)})
        log(f"[escalation] (b) K8 launch (n_pad={n_pad}, V_pad={v_pad}, "
            f"iters={args[3]}): {k8[-1]['ms']:.4f} ms, bound "
            f"{k8[-1]['bound_ms']:.4f} ms")
    del k8_calls
    torch.cuda.empty_cache()
    out["escalation"] = {
        "rows": ESC_ROWS, "budget": ESC_BUDGET, "wall_s": wall,
        "off_wall_s": off_s, "span_s": walls.get("escalation", 0.0),
        "tier_walls": tier_walls,
        "routed": summary["routed"], "escalated": summary["escalated"],
        "tiers": tiers, "joint_cells": joint_cells, "f1_off": f1_off,
        "f1_on": f1_on, "k8": k8, "k8_launches": k_joint.launches}

    # (c), CPU against card, is a card test since slice 9
    # (tests/test_torch_cuda.py::test_escalation_and_ledger_card_match_cpu,
    # escalation_cross_check at CHECK_2K_ROWS rows)

    # (d) the CLI with --escalate and --provenance-out in a subprocess
    sdirty, _ = escalation_table(ESC_CHECK_ROWS)
    csv_in = os.path.join(tmp, "esc.csv")
    sdirty.to_csv(csv_in, index=False)
    csv_out, led = os.path.join(tmp, "esc_out.csv"), os.path.join(
        tmp, "esc.jsonl")
    env = {k: v for k, v in os.environ.items()
           if k not in ("DELPHI_TORCH_DEVICE", "DELPHI_PROVENANCE_PATH")}
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "delphi_tpu_torch.main", "--input", csv_in,
         "--row-id", "tid", "--output", csv_out, "--escalate",
         "--escalate-budget", str(ESC_CHECK_BUDGET), "--provenance-out",
         led], cwd=HERE, env=env, capture_output=True, text=True,
        timeout=600)
    cli_s = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"cli (d): exit {proc.returncode}: {proc.stderr[-2000:]}")
    frame = escalation_model(T, pd.read_csv(csv_in), ESC_CHECK_BUDGET,
                             detectors=False).run()
    want = os.path.join(tmp, "esc_in_process.csv")
    frame.to_csv(want, index=False)
    with open(csv_out) as a, open(want) as b:
        if a.read() != b.read() or not len(frame):
            fail("cli (d): the CLI's CSV differs from the in-process frame")
    with open(led, "rb") as f:
        if not f.readline().startswith(LEDGER_HEADER):
            fail("cli (d): the ledger file lacks the envelope header")
    out["cli"] = {"rows": ESC_CHECK_ROWS, "wall_s": cli_s,
                  "repairs": len(frame), "ledger_bytes": os.path.getsize(led)}
    log(f"[escalation] (d) python -m delphi_tpu_torch.main --escalate "
        f"--provenance-out on {ESC_CHECK_ROWS} rows: {cli_s:.3f} s including "
        f"the interpreter; CSV ({len(frame)} rows) equal to the in-process "
        "run's; the ledger file starts with the envelope header")
    log(f"[ledger-escalation] summary {json.dumps(out, default=str)}")
    return out


def incremental_table(n: int):
    """(base, appended) frames equal to the JAX package's
    ``bench._incremental_frames(n)``, built with numpy: 32 groups keyed by
    c0, c1 and c3 functions of the group, every 11th base row's c1 NULL;
    ``max(4, n // 10)`` rows appended in groups 0-3, every third with c1
    NULL."""
    import pandas as pd

    def rows(ids, gid, null):
        g = gid.astype(str)
        c1 = np.char.add("v", (gid % 7).astype(str)).astype(object)
        c1[null] = None
        return pd.DataFrame({
            "tid": ids.astype(str).tolist(),
            "c0": np.char.add("g", g).tolist(), "c1": c1.tolist(),
            "c2": ((ids * 7) % 5).astype(str).tolist(),
            "c3": np.char.add("w", (gid % 5).astype(str)).tolist()})

    i = np.arange(n)
    j = np.arange(max(4, n // 10))
    base = rows(i, i % 32, i % 11 == 0)
    extra = rows(n + j, j % 4, j % 3 == 0)
    return base, pd.concat([base, extra], ignore_index=True)


def stream_table(n: int):
    """A table shaped like ``bench._stream_frames``: 8 groups keyed by c0,
    c1 and c3 functions of the group, every 11th c1 NULL, so every chunk of
    a stream holds a clean example of every group."""
    import pandas as pd
    i = np.arange(n)
    gid = i % 8
    c1 = np.char.add("v", (gid % 7).astype(str)).astype(object)
    c1[i % 11 == 0] = None
    return pd.DataFrame({
        "tid": i.astype(str).tolist(),
        "c0": np.char.add("g", gid.astype(str)).tolist(), "c1": c1.tolist(),
        "c2": ((i * 7) % 5).astype(str).tolist(),
        "c3": np.char.add("w", (gid % 5).astype(str)).tolist()})


def tensor_devices(obj) -> set:
    """Device types of every tensor reachable from ``obj`` through dicts,
    lists, tuples and the port's objects."""
    import torch
    seen, stack, found = set(), [obj], set()
    while stack:
        o = stack.pop()
        if isinstance(o, torch.Tensor):
            found.add(o.device.type)
            continue
        if id(o) in seen:
            continue
        seen.add(id(o))
        if isinstance(o, dict):
            stack.extend(o.values())
        elif isinstance(o, (list, tuple)):
            stack.extend(o)
        elif type(o).__module__.startswith("delphi_tpu_torch"):
            stack.extend(vars(o).values())
    return found


def dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files)


def incremental_and_stream(torch, T, traced) -> dict:
    """4j: (a) populate, delta and fresh runs of the clean-append workload
    at INC_ROWS rows, the delta a main path ("incremental"); (b) CPU
    against card at INC_CHECK_ROWS rows through populate, append and
    update deltas; (c) the CLI's --stream and --fsck."""
    import contextlib
    import io
    import pickle
    import tempfile

    import pandas as pd
    from delphi_tpu_torch import main as cli
    from delphi_tpu_torch.incremental import manifest as mf
    from delphi_tpu_torch.parallel import store
    from delphi_tpu_torch.utils import counters, phase_walls
    out = {"rows": INC_ROWS, "appended": INC_APPEND}
    tmp = tempfile.mkdtemp(prefix="delphi_smoke_")

    def model(df, snap_dir):
        m = T.delphi.repair.setInput(df).setRowId("tid").setErrorDetectors([
            T.NullErrorDetector(),
            T.ConstraintErrorDetector(constraints=INC_CONSTRAINTS)])
        if snap_dir is not None:
            m = m.option("repair.incremental", "true") \
                .option("repair.snapshot.dir", snap_dir)
        return m

    def run(df, snap_dir):
        m = model(df, snap_dir)
        return m.run(), m._last_incremental

    def timed_run(df, snap_dir):
        phase_walls.clear()
        counters.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        frame, summary = run(df, snap_dir)
        torch.cuda.synchronize()
        return (frame, summary, time.perf_counter() - t0, dict(counters),
                {k: round(v, 3) for k, v in phase_walls.items()})

    # (a) the clean-append A/B at full size, with the in-memory ledger the
    # JAX package's A/B splices
    t0 = time.perf_counter()
    base, appended = incremental_table(INC_ROWS)
    log(f"[incremental] generated {len(base)} + {len(appended) - len(base)} "
        f"rows in {time.perf_counter() - t0:.1f} s")
    snap = os.path.join(tmp, "snap")
    os.environ["DELPHI_PROVENANCE_PATH"] = ":memory:"
    try:
        _, p_sum, p_wall, p_counts, p_walls = timed_run(base, snap)
        (d_frame, d_sum), d_wall, launches, d_counts, d_walls, peak, _ = \
            traced("incremental", lambda: run(appended, snap))
        f_frame, _, f_wall, f_counts, f_walls = timed_run(appended, None)
    finally:
        del os.environ["DELPHI_PROVENANCE_PATH"]
    try:
        pd.testing.assert_frame_equal(d_frame, f_frame)
    except AssertionError as e:
        fail(f"incremental (a): the delta frame differs from the fresh "
             f"frame: {e}")
    checks = {
        "populate is a counted no_manifest fallback":
            p_sum["fallback_reason"] == "no_manifest"
            and p_counts.get("incremental.fallback") == 1,
        "delta mode": d_sum["mode"] == "delta",
        "rows pulled in by the constraint": d_sum["rows_expanded"] > 0,
        "rows replanned below the table's":
            0 < d_counts.get("incremental.rows_replanned", 0)
            < len(appended),
        "a model reused": d_sum["models_reused"] >= 1,
        "ledger cells spliced": d_sum["cells_spliced_reused"] > 0,
        "fewer rows scanned": d_counts["detect.rows_scanned"]
        < f_counts["detect.rows_scanned"],
        "fewer cells scored": d_counts["domain.cells_scored"]
        < f_counts["domain.cells_scored"],
        "K1 and K2 launched": min(launches.values()) >= 1,
    }
    for what, ok in checks.items():
        if not ok:
            fail(f"incremental (a): {what} does not hold: summary "
                 f"{json.dumps(d_sum, default=str)}, counters "
                 f"{json.dumps(d_counts)}, fresh {json.dumps(f_counts)}, "
                 f"launches {launches}")
    payload, status = store.read_bytes(
        os.path.join(snap, mf.STATE_FILE), schema="snapshot_state",
        site="store.snapshot_state")
    state = pickle.loads(payload) if status == "ok" else None
    if state is None or "cuda" in tensor_devices(state) \
            or not state["models"]:
        fail(f"incremental (a): state.pkl unreadable ({status}), without "
             "models, or holding a tensor on the card")
    out["a"] = {
        "populate_s": p_wall, "delta_s": d_wall, "fresh_s": f_wall,
        "fresh_over_delta": f_wall / d_wall, "snapshot_bytes":
        dir_bytes(snap), "peak_mib": peak, "launches": launches,
        "plan": {k: d_sum[k] for k in (
            "rows_appended", "rows_expanded", "rows_planned",
            "models_reused", "models_retrained", "cells_spliced_reused")},
        "rows_scanned": [d_counts["detect.rows_scanned"],
                         f_counts["detect.rows_scanned"]],
        "cells_scored": [d_counts["domain.cells_scored"],
                         f_counts["domain.cells_scored"]],
        "walls": {"populate": p_walls, "delta": d_walls, "fresh": f_walls}}
    log(f"[incremental] (a) {INC_ROWS} rows + {INC_APPEND} appended: "
        f"populate {p_wall:.3f} s, delta {d_wall:.3f} s, fresh "
        f"{f_wall:.3f} s (fresh/delta {f_wall / d_wall:.2f}x, reported, "
        f"not gated); delta frame identical to the fresh frame "
        f"({len(d_frame)} repairs); snapshot {out['a']['snapshot_bytes']} "
        f"bytes, no tensor on the card; {json.dumps(out['a'], default=str)}")

    # (b) CPU against card: populate, append delta, update delta
    t0 = time.perf_counter()
    sbase, sapp = incremental_table(INC_CHECK_ROWS)
    supd = sapp.copy()
    lo, hi = INC_UPDATE_ROWS
    supd.loc[lo:hi - 1, "c2"] = [str((i * 3) % 5) for i in range(lo, hi)]
    keys = ("fallback_reason", "columns_clean", "columns_dirty",
            "rows_updated", "rows_appended", "rows_expanded",
            "rows_planned", "attrs_reusable", "models_reused",
            "models_retrained", "cells_spliced_reused", "snapshot_id")
    runs = {}
    os.environ["DELPHI_PROVENANCE_PATH"] = ":memory:"
    try:
        for dev in ("cpu", "cuda"):
            T.set_device(dev)
            d = os.path.join(tmp, f"check_{dev}")
            runs[dev] = []
            for df in (sbase, sapp, supd):
                frame, summary = run(df, d)
                runs[dev].append((frame, {k: summary.get(k) for k in keys},
                                  mf.load_state(d)["ledger_entries"]))
    finally:
        del os.environ["DELPHI_PROVENANCE_PATH"]
        T.set_device("cuda")
    for step, (c, g) in enumerate(zip(runs["cpu"], runs["cuda"])):
        label = f"incremental (b) {('populate', 'append', 'update')[step]}"
        if not g[0].equals(c[0]) or not len(g[0]):
            fail(f"{label}: the card's frame differs from the CPU's")
        if g[1] != c[1]:
            fail(f"{label}: plans differ: {g[1]} against {c[1]}")
        entries_match(label, g[2], c[2])
    upd = runs["cuda"][2][1]
    if runs["cuda"][1][1]["fallback_reason"] is not None \
            or upd["fallback_reason"] is not None \
            or upd["rows_updated"] != hi - lo:
        fail(f"incremental (b): the deltas were not planned as such: {upd}")
    out["b"] = {"rows": INC_CHECK_ROWS, "append": runs["cuda"][1][1],
                "update": upd, "entries": len(runs["cuda"][2][2])}
    log(f"[incremental] (b) {INC_CHECK_ROWS} rows, CPU against card: "
        f"populate, append and update-delta frames, plans and ledger "
        f"entries (confidences within {LEDGER_TOL}) equal: "
        f"{json.dumps(out['b'], default=str)} "
        f"({time.perf_counter() - t0:.1f} s)")

    # (c) the CLI's --stream in a subprocess against one batch run, then
    # --fsck on the stream's directory, clean and with a flipped byte
    t0 = time.perf_counter()
    csv_in = os.path.join(tmp, "stream.csv")
    stream_table(STREAM_ROWS).to_csv(csv_in, index=False)
    sdir = os.path.join(tmp, "stream")
    streamed, batch = (os.path.join(tmp, f"{k}.csv")
                       for k in ("streamed", "batch"))
    env = {k: v for k, v in os.environ.items()
           if k not in ("DELPHI_TORCH_DEVICE", "DELPHI_PROVENANCE_PATH")}
    proc = subprocess.run(
        [sys.executable, "-m", "delphi_tpu_torch.main", "--input", csv_in,
         "--row-id", "tid", "--output", streamed, "--stream",
         str(STREAM_CHUNKS), "--snapshot-dir", sdir], cwd=HERE, env=env,
        capture_output=True, text=True, timeout=600)
    stream_s = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"stream (c): exit {proc.returncode}: {proc.stderr[-2000:]}")
    t1 = time.perf_counter()
    if cli.main(["--input", csv_in, "--row-id", "tid", "--output",
                 batch]) != 0:
        fail("stream (c): the batch CLI run failed")
    batch_s = time.perf_counter() - t1
    with open(streamed) as a, open(batch) as b:
        text = a.read()
        if text != b.read() or len(text.splitlines()) < 2:
            fail("stream (c): the streamed CSV differs from the batch CSV")

    def fsck():
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["--fsck", sdir])
        return rc, json.loads(buf.getvalue())

    rc_clean, clean = fsck()
    manifest = os.path.join(sdir, "snapshot", mf.MANIFEST_FILE)
    with open(manifest, "r+b") as f:
        blob = f.read()
        at = len(blob) // 2
        f.seek(at)
        f.write(bytes([blob[at] ^ 0x20]))
    rc_dirty, dirty = fsck()
    if rc_clean != 0 or clean["corrupt"] or rc_dirty != 4 \
            or dirty["quarantined"] != 1 or os.path.exists(manifest):
        fail(f"stream (c): fsck exit codes {rc_clean}, {rc_dirty} (want 0, "
             f"4): {json.dumps(clean)} then {json.dumps(dirty)}")
    out["c"] = {"rows": STREAM_ROWS, "chunks": STREAM_CHUNKS,
                "stream_s": stream_s, "batch_s": batch_s,
                "repairs": len(text.splitlines()) - 1,
                "fsck": [rc_clean, clean["ok"], rc_dirty, dirty["corrupt"]],
                "stream_bytes": dir_bytes(sdir)}
    log(f"[stream] (c) python -m delphi_tpu_torch.main --stream "
        f"{STREAM_CHUNKS} on {STREAM_ROWS} rows: {stream_s:.3f} s including "
        f"the interpreter, CSV equal to the batch CLI's ({batch_s:.3f} s in "
        f"process); --fsck exit 0 ({clean['ok']} files ok), then 4 with the "
        f"flipped manifest quarantined; {json.dumps(out['c'])}")
    return out


def fault_counts(counts) -> dict:
    """The ``resilience.faults.*`` and ``resilience.degrade.*`` counts."""
    return {k: v for k, v in counts.items()
            if k.startswith(("resilience.faults.", "resilience.degrade."))}


def timed_run(torch, fn):
    """(result, wall s, counters, phase walls, histograms) of ``fn()``
    with every count cleared just before."""
    from delphi_tpu_torch.utils import counters, histograms, phase_walls
    counters.clear()
    phase_walls.clear()
    histograms.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return (res, wall, dict(counters),
            {k: round(v, 3) for k, v in phase_walls.items()},
            {k: list(v) for k, v in histograms.items()})


def domain_summary(label, counts, walls) -> dict:
    """The domain span of one traced run and what its weak-label demotion
    copied off the card, logged."""
    out = {"domain_s": walls.get("cell domain analysis"),
           "bytes_to_host": counts.get("domain.bytes_to_host", 0),
           "bucket_launches": counts.get("domain.bucket_launches", 0),
           "cells_scored": counts.get("domain.cells_scored", 0)}
    log(f"[{label}] cell domain analysis: {json.dumps(out)}")
    return out


def pipeline_summary(wall, counts, walls, hists) -> dict:
    """4l(a)'s numbers of one 1M run: wall, training span, ``pipeline.*``
    counters and the consumer's wait for prepared items."""
    wait = hists.get("pipeline.consumer_wait_seconds", [])
    return {"wall_s": wall, "training_s": walls.get("repair model training"),
            "pipeline": {k: v for k, v in counts.items()
                         if k.startswith("pipeline.")},
            "consumer_wait_s": sum(wait),
            "consumer_wait_max_s": max(wait) if wait else 0.0}


def planes(torch, T, traced, dirty, out, e2e_run) -> dict:
    """Phase 4l (module docstring): the pipeline thread, the bucketed
    domain route, persisted launch plans and the build cache on the card.
    ``e2e_run`` is phase 4's pipelined run (:func:`pipeline_summary`)."""
    import tempfile

    from delphi_tpu_torch.ops.kernels import build
    from delphi_tpu_torch.ops.kernels import domain_scores as k_domain
    from delphi_tpu_torch.utils import counters
    res = {}

    # (a) the 1M missing_heavy run of 4, pipelined (the default on the
    # card), against the same run with DELPHI_PIPELINE=0: 4's frame
    runs = {"pipelined": e2e_run}
    os.environ["DELPHI_PIPELINE"] = "0"
    try:
        frame, wall, counts, walls, hists = timed_run(
            torch, lambda: repair(T, dirty))
    finally:
        del os.environ["DELPHI_PIPELINE"]
    if not frame.equals(out):
        fail("planes (a): the frame with DELPHI_PIPELINE=0 differs from 4's")
    runs["sequential"] = pipeline_summary(wall, counts, walls, hists)
    if runs["pipelined"]["pipeline"].get("pipeline.items", 0) < 2 \
            or runs["sequential"]["pipeline"]:
        fail(f"planes (a): pipeline counters {runs}")
    res["pipeline"] = runs
    log(f"[planes] (a) {E2E_ROWS} rows missing_heavy, pipelined against "
        f"DELPHI_PIPELINE=0: frames identical to 4's; {json.dumps(runs)}")

    # (b) fd_table at BUCKET_ROWS rows: the bucketed domain route (traced
    # as a path, "bucketed") against DELPHI_DEVICE_TABLE=0, at one GBDT
    # config per target (training is not what differs)
    _, fdirty, _ = fd_table(BUCKET_ROWS, seed=11)
    routes = {}
    for label, env in (("bucketed", None), ("legacy", "0")):
        if env is not None:
            os.environ["DELPHI_DEVICE_TABLE"] = env
        try:
            cells, _, _, _, _ = timed_run(
                torch, lambda: dc_model(T, fdirty).run(
                    detect_errors_only=True))
            k_domain.reset_launches()
            run = lambda: dc_model(T, fdirty).option(  # noqa: E731
                "model.hp.max_evals", "1").run()
            if label == "bucketed":
                frame, wall, _, counts, walls, _, _ = traced(label, run)
            else:
                frame, wall, counts, walls, _ = timed_run(torch, run)
        finally:
            os.environ.pop("DELPHI_DEVICE_TABLE", None)
        routes[label] = (cells, frame, {
            "wall_s": wall, "domain_s": walls.get("cell domain analysis"),
            "error_cells": len(cells), "repairs": len(frame),
            "k5_launches": k_domain.launches,
            "counters": {k: v for k, v in counts.items()
                         if k.startswith(("launch.phase.domain.",
                                          "domain."))}})
    (c_b, f_b, r_b), (c_l, f_l, r_l) = routes["bucketed"], routes["legacy"]
    if not c_b.equals(c_l) or not f_b.equals(f_l):
        fail("planes (b): the bucketed and legacy routes' error cells or "
             "frames differ")
    if r_b["k5_launches"] < 1 or r_l["k5_launches"] != 0:
        fail(f"planes (b): K5 launches {r_b['k5_launches']} bucketed, "
             f"{r_l['k5_launches']} legacy")
    res["domain_routes"] = {"bucketed": r_b, "legacy": r_l}
    log(f"[planes] (b) {BUCKET_ROWS} rows fd_table: error cells after "
        f"demotion and frames identical on both routes; "
        f"{json.dumps(res['domain_routes'])}")

    # (c) two runs with DELPHI_PLAN_DIR: the second loads every plan
    _, pdirty = missing_heavy(PLAN_ROWS, seed=12)
    plan_dir = tempfile.mkdtemp(prefix="delphi_plans_")
    os.environ["DELPHI_PLAN_DIR"] = plan_dir
    try:
        cold, cold_s, c_cold, _, _ = timed_run(
            torch, lambda: repair(T, pdirty, options=PLAN_OPTIONS))
        warm, warm_s, c_warm, _, _ = timed_run(
            torch, lambda: repair(T, pdirty, options=PLAN_OPTIONS))
    finally:
        del os.environ["DELPHI_PLAN_DIR"]
    plan_counts = lambda c: {k: v for k, v in c.items()  # noqa: E731
                             if k in ("launch.plan_cache.hits",
                                      "launch.replans")}
    if not warm.equals(cold) or c_warm.get("launch.plan_cache.hits", 0) < 1 \
            or c_warm.get("launch.replans", 0) != 0:
        fail(f"planes (c): warm run {plan_counts(c_warm)}, frames equal "
             f"{warm.equals(cold)}")
    res["plans"] = {"cold_s": cold_s, "warm_s": warm_s,
                    "cold": plan_counts(c_cold), "warm": plan_counts(c_warm),
                    "files": sorted(os.listdir(plan_dir))}
    res["plans_frame"] = cold
    log(f"[planes] (c) {PLAN_ROWS} rows missing_heavy at {PLAN_OPTIONS} with "
        f"DELPHI_PLAN_DIR: {json.dumps(res['plans'])}; frames identical")

    # (d) the build cache pointed at the library phase 2 built: a hit
    os.environ["DELPHI_COMPILE_CACHE_DIR"] = build.BUILD_DIR
    try:
        counters.clear()
        build.reset_library()
        t0 = time.perf_counter()
        build.library()
        load_s = time.perf_counter() - t0
    finally:
        del os.environ["DELPHI_COMPILE_CACHE_DIR"]
    cache = {k: v for k, v in counters.items()
             if k.startswith("compile_cache.")}
    if cache != {"compile_cache.requests": 1, "compile_cache.hits": 1}:
        fail(f"planes (d): build cache counters {cache}")
    res["compile_cache"] = {"load_s": load_s, **cache}
    log(f"[planes] (d) DELPHI_COMPILE_CACHE_DIR at phase 2's build: "
        f"{json.dumps(res['compile_cache'])}")
    return res


def spread(values) -> dict:
    """Median, least and largest of ``values``."""
    return {"median": statistics.median(values), "min": min(values),
            "max": max(values)}


def planes_ab(torch, T, pairs: int) -> dict:
    """``python3 chip_smoke.py --ab N``: N same-host pairs of 4l(a) (the
    1M ``missing_heavy`` run of 4, pipelined against
    ``DELPHI_PIPELINE=0``) and of 4l(b) (``fd_table`` at BUCKET_ROWS rows,
    one GBDT config, the bucketed domain route against
    ``DELPHI_DEVICE_TABLE=0``), each pair in alternating order (on, off,
    then off, on) after one unmeasured run of each: frames identical
    within each A/B; per run the wall and the span the setting moves
    (training, cell domain analysis), their median and spread, and the
    same of each pair's difference (on minus off)."""
    _, dirty = missing_heavy(E2E_ROWS, seed=0)
    _, fdirty, _ = fd_table(BUCKET_ROWS, seed=11)
    dc_run = lambda: dc_model(T, fdirty).option(  # noqa: E731
        "model.hp.max_evals", "1").run()
    cases = {"pipeline": ("DELPHI_PIPELINE", lambda: repair(T, dirty),
                          "repair model training"),
             "domain_route": ("DELPHI_DEVICE_TABLE", dc_run,
                              "cell domain analysis")}
    out = {}
    for name, (env, run, span) in cases.items():
        def one(on: bool):
            if not on:
                os.environ[env] = "0"
            try:
                frame, wall, _, walls, _ = timed_run(torch, run)
            finally:
                os.environ.pop(env, None)
            return frame, wall, walls.get(span, 0.0)

        want = one(True)[0]
        runs = {True: [], False: []}
        for i in range(pairs):
            for on in ((True, False) if i % 2 == 0 else (False, True)):
                frame, wall, span_s = one(on)
                if not frame.equals(want):
                    fail(f"ab {name}: the frame with {env} "
                         f"{'unset' if on else '0'} differs")
                runs[on].append((wall, span_s))
        res = {"pairs": pairs, "span": span}
        for label, on in (("on", True), ("off", False)):
            res[label] = {"wall_s": [w for w, _ in runs[on]],
                          "span_s": [t for _, t in runs[on]]}
            res[label]["wall"] = spread(res[label]["wall_s"])
            res[label]["span_stats"] = spread(res[label]["span_s"])
        res["diff"] = {
            "wall": spread([a[0] - b[0] for a, b in zip(runs[True],
                                                        runs[False])]),
            "span": spread([a[1] - b[1] for a, b in zip(runs[True],
                                                        runs[False])])}
        out[name] = res
        log(f"[ab] {name} ({env} unset against 0), {pairs} pairs, frames "
            f"identical: {json.dumps(res)}")
    return out


# One side of ``--domain-ab`` (:func:`parent_ab`): run from a tree's root,
# it imports that tree's package and chip_smoke (the parent commit's too),
# then runs the 1M NULL run of 4 and the 1M constraints run of 4f(b), once
# unmeasured
# and then argv[1] times each, and prints per run the wall, the domain
# span, the bytes the domain phase copied off the card and a digest of the
# frame. Both runs take one GBDT config: the domain phase runs before
# training.
DOMAIN_AB_CHILD = r"""
import json, sys
import pandas as pd
import torch
import chip_smoke as cs
import delphi_tpu_torch as T
T.set_device("cuda")
reps = int(sys.argv[1])
_, null_df = cs.missing_heavy(cs.E2E_ROWS, seed=0)
_, dc_df, _ = cs.fd_table(cs.DC_ROWS, seed=4)
one = {"model.hp.max_evals": "1"}
runs = {"null": lambda: cs.repair(T, null_df, options=one),
        "constraints": lambda: cs.dc_model(T, dc_df).option(
            "model.hp.max_evals", "1").run()}
out = {}
for name, run in runs.items():
    run()
    out[name] = []
    for _ in range(reps):
        frame, wall, counts, walls, _ = cs.timed_run(torch, run)
        out[name].append({
            "wall_s": wall, "domain_s": walls.get("cell domain analysis"),
            "bytes_to_host": counts.get("domain.bytes_to_host"),
            "digest": int(pd.util.hash_pandas_object(
                frame, index=False).sum())})
print("DOMAIN_AB " + json.dumps(out), flush=True)
"""


def parent_ab(tag: str, child: str, parent: str, reps: int) -> dict:
    """``python3 chip_smoke.py --domain-ab|--gbdt-ab|--logreg-ab PARENT
    REPS``: this tree against the parent commit's (a ``git archive`` copy at
    PARENT), same host, in four processes in the order parent, change,
    change, parent, each running ``child`` (:data:`DOMAIN_AB_CHILD`,
    :data:`GBDT_AB_CHILD`, :data:`LOGREG_AB_CHILD`) from its tree's root
    with REPS. A child prints
    one line ``<TAG> {name: [run, ...]}``; the runs' digests, where they
    have one, must be equal on both sides. Returns the runs and, per side
    and name, the spread of every other number of a run (a value that is
    not a number on every run: the first run's)."""
    out = {"parent": {}, "change": {}}
    mark = tag.upper().replace("-", "_") + " "
    for side in ("parent", "change", "change", "parent"):
        root = os.path.abspath(parent) if side == "parent" else HERE
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-c", child, str(reps)],
                              cwd=root, capture_output=True, text=True,
                              timeout=900)
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith(mark)]
        if proc.returncode or not lines:
            fail(f"{tag}: the {side} process failed:\n"
                 f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
        res = json.loads(lines[-1][len(mark):])
        for name, runs in res.items():
            out[side].setdefault(name, []).extend(runs)
        log(f"[{tag}] {side} ({root}, {time.perf_counter() - t0:.1f} s): "
            f"{json.dumps(res)}")
    summary = {side: {} for side in out}
    for name in out["change"]:
        digests = {r["digest"] for side in out for r in out[side][name]
                   if "digest" in r}
        if len(digests) > 1:
            fail(f"{tag}: the {name} frames differ between the parent and "
                 "the change")
        for side in out:
            runs = out[side][name]
            summary[side][name] = {
                k: spread([r[k] for r in runs])
                if all(isinstance(r[k], (int, float)) for r in runs)
                else runs[0][k] for k in runs[0] if k != "digest"}
    log(f"[{tag}] frames equal on both sides; {json.dumps(summary)}")
    return {"runs": out, "summary": summary}


# One side of ``--logreg-ab`` (:func:`parent_ab`): after a first fit (the
# kernels' build and load), argv[1] warm gather fits of 4d's sample (the
# zones table's 10,000 rows, as 4d's warm fit), each with its seconds,
# steps, ms a step and the fitted weights' digest
LOGREG_AB_CHILD = r"""
import hashlib, json, sys, time
import numpy as np
import torch
import chip_smoke as cs
import delphi_tpu_torch as T
from delphi_tpu_torch.models.encoding import FeatureEncoder
from delphi_tpu_torch.models.linear import LogisticRegressionModel
T.set_device("cuda")
reps = int(sys.argv[1])
zclean, _ = cs.zones_table(cs.LOGISTIC_ROWS, seed=2)
sample = zclean.sample(n=10_000, random_state=0)
design = FeatureEncoder(["district", "parity", "channel", "amount"],
                        ["amount"]).fit_transform_compact(sample)
LogisticRegressionModel().fit(design, sample["zone"])
runs = []
for _ in range(reps):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    m = LogisticRegressionModel().fit(design, sample["zone"])
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    digest = hashlib.sha1(b"".join(np.ascontiguousarray(p).tobytes()
                                   for p in m._params)).hexdigest()
    runs.append({"fit_s": fit_s, "steps": m.n_steps_run_,
                 "ms_per_step": 1e3 * fit_s / m.n_steps_run_,
                 "digest": digest})
print("LOGREG_AB " + json.dumps({"warm_fit": runs}), flush=True)
"""


# One side of ``--gbdt-ab`` (:func:`parent_ab`): after a 20,000-row warm-up,
# argv[1] times the 1M NULL run (4's table and options) and 4r's
# 100,000-row table A through ``run()``, each with its wall, training span
# and frame digest, and 4e's ms per round at depths 3 and 5
GBDT_AB_CHILD = r"""
import json, sys, time
import pandas as pd
import torch
import chip_smoke as cs
import delphi_tpu_torch as T
from delphi_tpu_torch.models import gbdt
from delphi_tpu_torch.utils import phase_walls
T.set_device("cuda")
reps = int(sys.argv[1])
_, null_df = cs.missing_heavy(cs.E2E_ROWS, seed=0)
_, serve_df = cs.missing_heavy(cs.SERVE_ROWS, seed=cs.SERVE_SEEDS[0])
cs.repair(T, cs.missing_heavy(cs.CHECK_ROWS, seed=1)[1])   # warm-up


def round_ms(depth):
    # 4e's timing at its shapes (3 folds x 8 class trees, 10,000 rows, 4
    # features), written out: the parent's boost_round_profile takes other
    # arguments
    g = torch.Generator(device="cuda").manual_seed(0)
    M, k, n, d = 3, 8, 10_000, 4
    bins = torch.randint(0, 64, (M, n, d), device="cuda", generator=g)
    y = torch.randint(0, 6, (M, n), device="cuda", generator=g).float()
    w = torch.ones((M, n), device="cuda")
    F = torch.zeros((M, k, n), device="cuda")
    run = lambda r: gbdt._boost(bins, y, w, F, r, depth, 64, "multiclass",
                                k, 0.1, 1.0, 0.0, 1.0, 0.0, use_counts=False,
                                collect_trees=False)
    run(1)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    run(4)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 4


out = {"null_1m": [], "table_100k": [], "round_ms": []}
for _ in range(reps):
    for name, df in (("null_1m", null_df), ("table_100k", serve_df)):
        phase_walls.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        frame = cs.repair(T, df)
        torch.cuda.synchronize()
        out[name].append({
            "wall_s": time.perf_counter() - t0,
            "training_s": phase_walls.get("repair model training"),
            "digest": int(pd.util.hash_pandas_object(
                frame, index=False).sum())})
    out["round_ms"].append({"depth3": round_ms(3), "depth5": round_ms(5)})
print("GBDT_AB " + json.dumps(out), flush=True)
"""


def resilience_plane(torch, T, traced, dirty, frame) -> dict:
    """Phase 4k: resume, retries, the ladder, the CLI's flags, CPU against
    card and model checkpoints, on the card. ``dirty`` and ``frame`` are
    4's 1M table and its repair frame."""
    import tempfile

    import pandas as pd

    from delphi_tpu_torch import main as cli
    from delphi_tpu_torch.observability import provenance as prov
    from delphi_tpu_torch.ops.kernels import build
    from delphi_tpu_torch.ops.kernels import pair_counts as k_pair
    from delphi_tpu_torch.parallel import resilience as rz
    from delphi_tpu_torch.parallel import store
    from delphi_tpu_torch.utils import counters, phase_walls

    root = tempfile.mkdtemp(prefix="delphi_smoke_4k_")
    out = {}

    def counted(fn, plan=""):
        """(result, wall s, counters, phase walls, guarded entries) of
        ``fn()`` under ``plan``."""
        os.environ["DELPHI_FAULT_PLAN"] = plan
        rz.reset_fault_state()
        counters.clear()
        phase_walls.clear()
        rz.entries.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            res = fn()
            torch.cuda.synchronize()
        finally:
            del os.environ["DELPHI_FAULT_PLAN"]
            rz.reset_fault_state()
        return (res, time.perf_counter() - t0, dict(counters),
                {k: round(v, 3) for k, v in phase_walls.items()},
                dict(rz.entries))

    # save and load seconds of the phase store
    io_s = {"save": 0.0, "load": 0.0}
    orig_io = {k: getattr(rz.PhaseCheckpointStore, k) for k in io_s}

    def timed_io(name):
        def call(self, *args):
            t0 = time.perf_counter()
            try:
                return orig_io[name](self, *args)
            finally:
                io_s[name] += time.perf_counter() - t0
        return call

    # -- (a) resume at 1M rows ------------------------------------------------
    ck = os.path.join(root, "a")
    os.environ["DELPHI_CHECKPOINT_DIR"] = ck
    for name in io_s:
        setattr(rz.PhaseCheckpointStore, name, timed_io(name))
    try:
        def killed():
            try:
                repair(T, dirty)
            except rz.FaultInjected:
                return True
            return False

        died, wall_a, _, _, _ = counted(killed, PLAN_FATAL)
        if not died:
            fail(f"4k (a): run A under {PLAN_FATAL} did not raise "
                 "FaultInjected")
        detect_pkl = os.path.join(ck, "phase_detect.pkl")
        if not os.path.isfile(detect_pkl):
            fail("4k (a): run A left no phase_detect.pkl")
        saved_a = dict(io_s)
        b, wall_b, cb, wb, _ = counted(lambda: repair(T, dirty))
        c, wall_c, cc, wc, _ = counted(lambda: repair(T, dirty))
    finally:
        del os.environ["DELPHI_CHECKPOINT_DIR"]
        for name, fn in orig_io.items():
            setattr(rz.PhaseCheckpointStore, name, fn)
    train_b = wb.get("repair model training", 0.0)
    train_c = wc.get("repair model training", 0.0)
    if cb.get("resilience.checkpoint.hits") != 1 or train_b <= 0:
        fail(f"4k (a): run B did not resume and train: {cb}, {wb}")
    if cc.get("resilience.checkpoint.hits") != 2 or train_c >= 0.05 * train_b:
        fail(f"4k (a): run C did not skip training: {cc}, {wc}")
    for label, f in (("B", b), ("C", c)):
        if not f.equals(frame):
            fail(f"4k (a): run {label}'s frame differs from 4's 1M frame")
    files = {f: os.path.getsize(os.path.join(ck, f))
             for f in sorted(os.listdir(ck)) if f.endswith(".pkl")}
    out["resume"] = {"rows": len(dirty), "walls_s": [wall_a, wall_b, wall_c],
                     "bytes": files, "save_s": io_s["save"],
                     "load_s": io_s["load"], "save_s_run_a": saved_a["save"],
                     "train_s": [train_b, train_c]}
    log(f"[resilience] (a) {len(dirty)} rows: A (killed at its first GBDT "
        f"launch) {wall_a:.3f} s, B (resumed) {wall_b:.3f} s, C (both "
        f"phases resumed) {wall_c:.3f} s; training {train_b:.3f} / "
        f"{train_c:.3f} s; files {files} bytes; save {io_s['save']:.3f} s, "
        f"load {io_s['load']:.3f} s; B and C frames identical to 4's")

    # -- (b) retry and the refused CPU rung at RES_ROWS rows -----------------
    # the unfaulted frame is (e)'s first run, which saves the models
    _, d200 = missing_heavy(RES_ROWS, seed=7)
    mdir = os.path.join(root, "model")
    model_opts = {"model.checkpoint_path": mdir}
    base, wall_base, _, _, base_entries = counted(
        lambda: repair(T, d200, options=model_opts))

    def with_ledger(fn):
        led = prov.ProvenanceLedger(prov.MEMORY_PATH)
        with prov.scoped_ledger(led):
            res = fn()
        return res, led
    os.environ["DELPHI_FAULT_PLAN"] = PLAN_RETRY
    rz.reset_fault_state()
    try:
        (retry, _), wall_retry, launches, c_retry, _, _, _ = traced(
            "resilience", lambda: with_ledger(lambda: repair(T, d200)),
            faults_ok=True)
    finally:
        del os.environ["DELPHI_FAULT_PLAN"]
        rz.reset_fault_state()
    if c_retry.get("resilience.faults.oom") != 1 \
            or c_retry.get("resilience.retries") != 1 \
            or fault_counts(c_retry) != {"resilience.faults.oom": 1}:
        fail(f"4k (b): the retry run's counters are {c_retry}")
    if launches["pair_counts"] < 1 or launches["entropy_terms"] < 1:
        fail(f"4k (b): the retry run launched {launches}")
    if not retry.equals(base):
        fail("4k (b): the retry frame differs from the unfaulted one")
    led = prov.ProvenanceLedger(prov.MEMORY_PATH)
    k1_before = k_pair.launches

    def refused():
        try:
            with prov.scoped_ledger(led):
                repair(T, d200)
        except rz.FaultInjected as e:
            return rz.classify_fault(e)
        fail(f"4k (b): {PLAN_LADDER} did not raise on the card")

    ladder_kind, wall_ladder, c_ladder, _, _ = counted(refused, PLAN_LADDER)
    notes = [(n["note"], n["detail"]) for n in led.notes()]
    if ladder_kind != "oom" or fault_counts(c_ladder) != {
            "resilience.faults.oom": 3, "resilience.degrade.cpu_refused": 1} \
            or notes != [("resilience.cpu_refused", "freq.pairs_pallas: oom")]:
        fail(f"4k (b): the refused rung raised {ladder_kind}, counters "
             f"{c_ladder}, notes {notes}")
    if k_pair.launches != k1_before or rz.cpu_fallback_active():
        fail("4k (b): the refused rung launched K1 or left the CPU latched")
    after, wall_after, c_after, _, _ = counted(lambda: repair(T, d200))
    if not after.equals(base) or fault_counts(c_after) \
            or k_pair.launches == k1_before:
        fail(f"4k (b): the run after the refusal: counters {c_after}, frame "
             f"equal {after.equals(base)}")
    try:
        torch.empty(2 ** 40, device="cuda")
        fail("4k (b): a 2^40-byte allocation succeeded")
    except torch.cuda.OutOfMemoryError as e:
        real_oom = rz.classify_fault(e)
    try:
        build.check(700, "pair_counts")
    except build.KernelLaunchError as e:
        launch_kind = rz.classify_fault(e)
    if real_oom != "oom" or launch_kind is not None:
        fail(f"4k (b): real OOM classified {real_oom}, a failed launch "
             f"{launch_kind}")
    out["ladder"] = {"rows": RES_ROWS, "walls_s": [wall_base, wall_retry,
                                                   wall_ladder, wall_after],
                     "retry_counters": fault_counts(c_retry),
                     "ladder_counters": fault_counts(c_ladder),
                     "entries": base_entries}
    log(f"[resilience] (b) {RES_ROWS} rows: unfaulted {wall_base:.3f} s, "
        f"one OOM at K1 retried {wall_retry:.3f} s (K1 {launches} on the "
        f"card, frame identical), three OOMs -> CPU rung refused on the "
        f"card, {ladder_kind} re-raised after {wall_ladder:.3f} s (note "
        f"{notes}), the next run {wall_after:.3f} s with an identical frame; "
        f"real OOM -> {real_oom}, failed launch -> {launch_kind}; guarded "
        f"entries {json.dumps(base_entries)}")

    # -- (c) the CLI at RES_CHECK_ROWS rows -----------------------------------
    _, d20 = missing_heavy(RES_CHECK_ROWS, seed=8)
    csv = os.path.join(root, "in.csv")
    d20.to_csv(csv, index=False)
    base_args = ["--input", csv, "--row-id", "tid"]

    def cli_run(name, *flags):
        path = os.path.join(root, name)
        rc = cli.main([*base_args, "--output", path, *flags])
        if rc != 0:
            fail(f"4k (c): the CLI exited {rc}")
        with open(path) as f:
            return f.read()

    d1 = os.path.join(root, "cli1")
    first, wall_c1, _, _, _ = counted(lambda: cli_run("c1.csv",
                                                      "--checkpoint-dir", d1))
    second, wall_c2, c_c2, _, _ = counted(lambda: cli_run(
        "c2.csv", "--checkpoint-dir", d1))
    if c_c2.get("resilience.checkpoint.hits") != 2 or second != first:
        fail(f"4k (c): the second --checkpoint-dir run: {c_c2}, CSV equal "
             f"{second == first}")
    d2 = os.path.join(root, "cli2")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "delphi_tpu_torch.main", *base_args,
         "--output", os.path.join(root, "crash.csv"), "--checkpoint-dir",
         d2, "--fault-plan", PLAN_CRASH],
        cwd=HERE, capture_output=True, text=True, timeout=600)
    wall_crash = time.perf_counter() - t0
    if proc.returncode != 23:
        fail(f"4k (c): --fault-plan {PLAN_CRASH} exited {proc.returncode}, "
             f"not 23:\n{proc.stderr[-2000:]}")
    rerun, wall_rerun, _, _, _ = counted(lambda: cli_run(
        "rerun.csv", "--checkpoint-dir", d2))
    if rerun != first:
        fail("4k (c): the re-run after the crash wrote another CSV")
    out["cli"] = {"rows": RES_CHECK_ROWS,
                  "walls_s": [wall_c1, wall_c2, wall_crash, wall_rerun]}
    log(f"[resilience] (c) CLI on {RES_CHECK_ROWS} rows: --checkpoint-dir "
        f"{wall_c1:.3f} s, again (both phases resumed) {wall_c2:.3f} s, "
        f"equal CSVs; --fault-plan {PLAN_CRASH} exited 23 in "
        f"{wall_crash:.1f} s (subprocess); the re-run {wall_rerun:.3f} s, "
        "CSV equal to the first")

    # -- (d) CPU against card at RES_CHECK_ROWS rows --------------------------
    t0 = time.perf_counter()
    _, d20c = missing_heavy(RES_CHECK_ROWS, seed=9)

    def check_run():
        return repair(T, d20c, options=RES_CHECK_OPTIONS)

    per_dev = {}
    for dev in ("cpu", "cuda"):
        T.set_device(dev)
        runs = {}
        ckd = os.path.join(root, f"d_{dev}")
        os.environ["DELPHI_CHECKPOINT_DIR"] = ckd
        try:
            def killed_small():
                try:
                    check_run()
                except rz.FaultInjected:
                    return None
                fail("4k (d): run A did not raise")

            for label, fn, plan in (("A", killed_small, PLAN_FATAL),
                                    ("B", check_run, ""),
                                    ("C", check_run, "")):
                res, _, cnt, _, ent = counted(fn, plan)
                runs[label] = (res, cnt, ent)
        finally:
            del os.environ["DELPHI_CHECKPOINT_DIR"]
        res, _, cnt, _, ent = counted(check_run, PLAN_RETRY)
        runs["retry"] = (res, cnt, ent)
        per_dev[dev] = runs
    T.set_device("cuda")
    entry_diffs = {}
    for label in per_dev["cpu"]:
        (f_cpu, c_cpu, e_cpu), (f_gpu, c_gpu, e_gpu) = \
            per_dev["cpu"][label], per_dev["cuda"][label]
        if (f_cpu is None) != (f_gpu is None) or (
                f_cpu is not None and not f_cpu.equals(f_gpu)):
            fail(f"4k (d) {label}: CPU and card frames differ")
        rc_cpu = {k: v for k, v in c_cpu.items()
                  if k.startswith("resilience.")}
        rc_gpu = {k: v for k, v in c_gpu.items()
                  if k.startswith("resilience.")}
        if rc_cpu != rc_gpu:
            fail(f"4k (d) {label}: resilience counters differ: CPU {rc_cpu} "
                 f"card {rc_gpu}")
        if e_cpu != e_gpu:
            entry_diffs[label] = {"cpu": e_cpu, "cuda": e_gpu}
    if entry_diffs:
        fail(f"4k (d): guarded entries per site differ: {entry_diffs}")
    frames_b = per_dev["cuda"]["B"][0]
    if not frames_b.equals(per_dev["cuda"]["C"][0]) or not frames_b.equals(
            per_dev["cuda"]["retry"][0]):
        fail("4k (d): the resumed, re-run and retried frames differ")
    out["cross_check"] = {"rows": RES_CHECK_ROWS,
                          "entries": per_dev["cuda"]["retry"][2],
                          "wall_s": time.perf_counter() - t0}
    log(f"[resilience] (d) {RES_CHECK_ROWS} rows, CPU against card under "
        f"{PLAN_FATAL} (A, B, C) and {PLAN_RETRY}: frames, "
        f"resilience counters and guarded entries per site equal "
        f"(retry run: {json.dumps(per_dev['cuda']['retry'][2])}) "
        f"({time.perf_counter() - t0:.1f} s)")

    # -- (e) model checkpoint at RES_ROWS rows: (b)'s base run saved it -----
    m2, wall_m2, c_m2, w_m2, _ = counted(lambda: repair(T, d200,
                                                        options=model_opts))
    if c_m2.get("train.checkpoint_hits") != 1 or not m2.equals(base):
        fail(f"4k (e): model checkpoint reuse {c_m2}, frames equal "
             f"{m2.equals(base)}")
    payload, status = store.read_pickle(
        os.path.join(mdir, "repair_models.pkl"), schema="model_ckpt",
        site="store.model")
    held = tensor_devices(payload)
    if status != "ok" or "cuda" in held:
        fail(f"4k (e): repair_models.pkl read {status}, tensors on {held}")
    ckpt_bytes = os.path.getsize(os.path.join(mdir, "repair_models.pkl"))
    out["model_checkpoint"] = {"rows": RES_ROWS,
                               "walls_s": [wall_base, wall_m2],
                               "bytes": ckpt_bytes}
    log(f"[resilience] (e) {RES_ROWS} rows with model.checkpoint_path: "
        f"{wall_base:.3f} s (b's base), then {wall_m2:.3f} s reusing the "
        "models "
        f"(training span {w_m2.get('repair model training', 0.0)} s), "
        f"identical frames; repair_models.pkl {ckpt_bytes} bytes, tensors "
        f"on {sorted(held) or 'none'}")
    return out


# -- 4m: the row-shard plane -------------------------------------------------

# 4m runs its rank processes through this script: ``python3 chip_smoke.py
# --shard-rank R`` with SHARD_SPEC (JSON) in the environment
SHARD_WORLD = 2
# a rank process's time limit: a hang fails the phase, not the script
SHARD_RANK_TIMEOUT_S = 420
SHARD_DEATH_PLAN = "1:shard.freq.merge:1:rank_death"


def shard_rank(rank: int) -> None:
    """One rank of phases 4m, 4o and 4p: joins the gloo group at
    SHARD_SPEC's coordinator with the spec's settings (4m: DELPHI_SHARD=1
    and DELPHI_MESH=off; 4o and 4p: none, the default mesh), runs each of
    the spec's repairs on ``missing_heavy`` or, for a run that names a
    ``csv`` (4p), on the rows of it that ``read_csv_encoded_sharded`` gives
    this rank (the counts zeroed just before and read just after each),
    records the K1, K2 and K5 inputs and the K3 / K4 calls of each
    structure of the runs marked ``record`` and writes its frames, counts
    and inputs under the spec's work directory.
    On a 4p run it also counts the seconds and bytes of every gather by
    kind and the gathered payloads that hold a CUDA tensor."""
    import torch
    spec = json.loads(os.environ["SHARD_SPEC"])
    os.environ.update(DELPHI_COORDINATOR=spec["coordinator"],
                      DELPHI_NUM_PROCESSES=str(SHARD_WORLD),
                      DELPHI_PROCESS_ID=str(rank), **spec["env"])
    sys.path.insert(0, HERE)
    import delphi_tpu_torch as T
    from delphi_tpu_torch.ops import domain as t_domain
    from delphi_tpu_torch.ops.kernels import domain_scores as k_domain
    from delphi_tpu_torch.ops.kernels import entropy as k_entropy
    from delphi_tpu_torch.ops.kernels import gbdt as k_gbdt
    from delphi_tpu_torch.ops.kernels import pair_counts as k_pair
    from delphi_tpu_torch.utils import counters, gauges, phase_walls

    rec = {"pair_counts": [], "entropy_terms": [], "entropy_owned": [],
           "weak_label": [], "domain_scores": [], "gbdt": {}}
    orig = (k_pair.pair_counts, k_entropy.entropy_terms,
            k_entropy.entropy_terms_owned, k_domain.weak_label,
            k_domain.domain_scores)
    recording = {"on": False, "pieces": None}

    def rec_pair_counts(codes, pairs, vocab):
        if recording["on"]:
            rec["pair_counts"].append((codes.cpu(), list(pairs), list(vocab)))
        return orig[0](codes, pairs, vocab)

    def rec_entropy_terms(counts, offsets, n_rows):
        if recording["on"]:
            rec["entropy_terms"].append(
                (counts.cpu(), np.asarray(offsets, np.int64), n_rows))
        return orig[1](counts, offsets, n_rows)

    def rec_entropy_owned(counts, offsets, n_rows, segments):
        if recording["on"]:
            rec["entropy_owned"].append(
                (counts.cpu(), np.asarray(offsets, np.int64), n_rows,
                 np.asarray(segments, np.int64)))
        return orig[2](counts, offsets, n_rows, segments)

    def rec_weak_label(ops, beta, n_rows):
        if recording["on"]:
            rec["weak_label"].append(
                (ops.codes.cpu(), ops.blob.cpu(), ops.layout, beta, n_rows,
                 recording["pieces"]))
        return orig[3](ops, beta, n_rows)

    def rec_domain_scores(ops):
        # the integer mode of 4o's cell-sharded scoring: one piece a call
        if recording["on"]:
            vcs = ops.vcs.cpu().numpy()
            rec["domain_scores"].append(
                (ops.codes.cpu(), ops.blob.cpu(), ops.layout,
                 [(m, v_a, tuple(int(c) for c in vcs[i]))
                  for i, (m, v_a) in enumerate(ops.layout.extents)]))
        return orig[4](ops)

    orig_bucket = t_domain._launch_bucket_once

    def rec_launch_bucket(batch, *rest):
        recording["pieces"] = [(len(p.rows), len(p.hs),
                                tuple(map(int, p.vcs))) for _, _, p in batch]
        return orig_bucket(batch, *rest)

    def rec_gbdt(name):
        fn_ = getattr(k_gbdt, name)

        def call(*args, **kwargs):
            if recording["on"]:
                gbdt_record(rec["gbdt"], name, fn_, args, kwargs,
                            copy=lambda t: t.cpu())
            return fn_(*args, **kwargs)
        return call

    for name in ("hist", "split", "route", "predict"):
        setattr(k_gbdt, name, rec_gbdt(name))
    k_pair.pair_counts, k_entropy.entropy_terms = rec_pair_counts, \
        rec_entropy_terms
    k_entropy.entropy_terms_owned = rec_entropy_owned
    k_domain.weak_label = rec_weak_label
    k_domain.domain_scores = rec_domain_scores
    t_domain._launch_bucket_once = rec_launch_bucket

    # 4p: every gather's seconds and bytes by kind (the gathers made while
    # reading are the ingestion's; a gathered frame is a training sample,
    # a gathered dict the fitted models), and every gathered payload that
    # holds a CUDA tensor
    from delphi_tpu_torch.ingest import read_csv_encoded_sharded
    from delphi_tpu_torch.parallel import distributed as t_dist
    gathers = {"label": "other", "stats": {}, "cuda_payloads": 0}
    orig_bytes, orig_pickled = t_dist.allgather_host_bytes, \
        t_dist.allgather_pickled

    def counted_bytes(payload, site="dist.allgather_bytes"):
        t0 = time.perf_counter()
        out = orig_bytes(payload, site=site)
        st = gathers["stats"].setdefault(
            gathers["label"], {"calls": 0, "bytes": 0, "seconds": 0.0})
        st["calls"] += 1
        st["bytes"] += len(payload)
        st["seconds"] += time.perf_counter() - t0
        return out

    def checked_pickled(obj, site="dist.allgather_bytes"):
        import pandas as pd
        if "cuda" in tensor_devices(obj):
            gathers["cuda_payloads"] += 1
        prior = gathers["label"]
        if gathers["label"] != "ingestion":
            gathers["label"] = "sample" if isinstance(obj, pd.DataFrame) \
                else "model" if isinstance(obj, dict) else "other"
        try:
            return orig_pickled(obj, site=site)
        finally:
            gathers["label"] = prior

    t_dist.allgather_host_bytes = counted_bytes
    t_dist.allgather_pickled = checked_pickled

    runs = []
    for i, run in enumerate(spec["runs"]):
        if run.get("plans"):
            os.environ["DELPHI_PLAN_DIR"] = os.path.join(
                spec["work"], f"{spec['name']}_plans_r{rank}")
        else:
            os.environ.pop("DELPHI_PLAN_DIR", None)
        if run.get("report"):
            os.environ["DELPHI_METRICS_PATH"] = os.path.join(
                spec["work"], f"{spec['name']}.report{i}.r{rank}.json")
        else:
            os.environ.pop("DELPHI_METRICS_PATH", None)
        ingest_s, n_local = None, None
        gathers["stats"], gathers["cuda_payloads"] = {}, 0
        if run.get("csv"):
            # 4p: this rank's chunks of the CSV, a process-local table
            dtype = _pl_dtypes(run["dtype"])
            gathers["label"] = "ingestion"
            t0 = time.perf_counter()
            table = read_csv_encoded_sharded(
                run["csv"], "tid", chunksize=run["chunksize"], dtype=dtype)
            ingest_s = time.perf_counter() - t0
            gathers["label"] = "other"
            n_local = table.n_rows
            if not table.process_local or n_local >= run["rows"]:
                fail(f"rank {rank}: read_csv_encoded_sharded gave "
                     f"{n_local} of {run['rows']} rows, process_local "
                     f"{table.process_local}")
            name = f"{spec['name']}_{i}_r{rank}"
            T.delphi.register_table(name, table)
        else:
            _, df = missing_heavy(run["rows"], seed=run["seed"])
        recording["on"] = bool(run.get("record"))
        counters.clear()
        phase_walls.clear()
        gauges.pop("shard.rows", None)
        gauges.pop("mesh.reduce_seconds", None)
        for k in (k_pair, k_entropy, k_domain, k_gbdt):
            k.reset_launches()
        owned0 = k_entropy.owned_launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if run.get("csv") and run.get("detectors") == "dc":
            frame = T.delphi.repair.setTableName(name).setRowId("tid") \
                .setTargets(DC_TARGETS).setErrorDetectors(dc_detectors(T)) \
                .run(detect_errors_only=bool(run.get("detect_only")))
        elif run.get("csv"):
            m = T.delphi.repair.setTableName(name).setRowId("tid") \
                .setErrorDetectors([T.NullErrorDetector()])
            for k, v in {**RUN_OPTIONS, **run["options"]}.items():
                m = m.option(k, v)
            frame = m.run()
        else:
            frame = repair(T, df, options=run["options"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        frame.to_pickle(os.path.join(
            spec["work"], f"{spec['name']}.frame{i}.r{rank}.pkl"))
        runs.append({
            "rows": run["rows"], "wall_s": wall,
            "phase_walls": {k: round(v, 3) for k, v in phase_walls.items()},
            "shard_rows": gauges.get("shard.rows"),
            "mesh_reduce_s": gauges.get("mesh.reduce_seconds"),
            "launches": {"pair_counts": k_pair.launches,
                         "entropy_terms": k_entropy.launches,
                         "entropy_terms_owned":
                             k_entropy.owned_launches - owned0,
                         "domain_scores_weak": k_domain.mode_launches["weak"],
                         "domain_scores_int": k_domain.mode_launches["int"],
                         **k_gbdt.launches},
            "ingest_s": ingest_s, "local_rows": n_local,
            "gathers": {k: dict(v) for k, v in gathers["stats"].items()},
            "cuda_payloads": gathers["cuda_payloads"],
            "counters": dict(counters)})
    torch.save(rec, os.path.join(spec["work"],
                                 f"{spec['name']}.inputs.r{rank}.pt"))
    with open(os.path.join(spec["work"],
                           f"{spec['name']}.result.r{rank}.json"), "w") as f:
        json.dump(runs, f)
    print(f"SHARD_RANK_OK rank={rank}", flush=True)


# 4m's rank settings: the row-shard plane with the device mesh off
SHARD_ENV = {"DELPHI_MESH": "off", "DELPHI_SHARD": "1"}


def shard_cluster(work: str, name: str, runs: list, env_extra=None,
                  rank_env=SHARD_ENV):
    """Runs the SHARD_WORLD rank processes of one 4m or 4o scenario (each
    with its own time limit, killed if still running), each rank with
    ``rank_env``; returns (exit codes, outputs, per-rank run summaries or
    None)."""
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("DELPHI_")}
    env["SHARD_SPEC"] = json.dumps({
        "coordinator": f"127.0.0.1:{port}", "work": work, "name": name,
        "runs": runs, "env": rank_env})
    env.update(env_extra or {})
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--shard-rank", str(r)],
        env=env, cwd=HERE, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(SHARD_WORLD)]
    codes, outs = [], []
    try:
        for p in procs:
            try:
                text, _ = p.communicate(timeout=SHARD_RANK_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                p.kill()
                text, _ = p.communicate()
            codes.append(p.returncode)
            outs.append(text)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    results = []
    for r in range(SHARD_WORLD):
        path = os.path.join(work, f"{name}.result.r{r}.json")
        results.append(json.load(open(path)) if os.path.exists(path)
                       else None)
    return codes, outs, results


def shard_reports(work: str, warm_runs: list) -> dict:
    """4m: the warm runs' run reports, one a rank; rank 0's (and rank
    1's) holds both ranks under ``per_process`` with the summed
    counters."""
    sys.path.insert(0, HERE)
    from delphi_tpu_torch.observability import load_run_report
    reports = [load_run_report(os.path.join(work, f"parity.report2.r{r}"
                                                  ".json"))
               for r in range(SHARD_WORLD)]
    for r, report in enumerate(reports):
        if report is None or report["status"] != "ok":
            fail(f"4m(b): rank {r} wrote no loadable run report")
        per = report["per_process"] or {}
        if sorted(per) != [str(q) for q in range(SHARD_WORLD)]:
            fail(f"4m(b): rank {r}'s report holds ranks {sorted(per)}")
        if report["dist"]["aggregation_incomplete"]:
            fail(f"4m(b): rank {r}'s report aggregation was incomplete")
    per = reports[0]["per_process"]
    merged = reports[0]["metrics"]["counters"]
    for key in ("detect.rows_scanned", "shard.merges"):
        want = sum(run["counters"].get(key, 0) for run in warm_runs)
        ranks = [per[str(q)]["metrics"]["counters"].get(key, 0)
                 for q in range(SHARD_WORLD)]
        if merged.get(key) != want or sum(ranks) != want:
            fail(f"4m(b): {key} merged {merged.get(key)}, per rank "
                 f"{ranks}, the runs counted {want}")
    out = {"ranks": sorted(per), "rows_scanned": merged.get(
        "detect.rows_scanned"), "bytes": [os.path.getsize(os.path.join(
            work, f"parity.report2.r{r}.json")) for r in range(SHARD_WORLD)]}
    log(f"[shard] (b) each rank wrote a run report of its warm run; rank "
        f"0's holds both ranks (per_process) with summed counters: "
        f"{json.dumps(out)}")
    return out


def shard_frame(work: str, name: str, run: int, rank: int):
    import pandas as pd
    return pd.read_pickle(os.path.join(work,
                                       f"{name}.frame{run}.r{rank}.pkl"))


def owners_of(sizes) -> list:
    """The row-shard plane's greedy owners (rowshard.assign_owners) for
    SHARD_WORLD ranks."""
    loads, owners = [0] * SHARD_WORLD, [0] * len(sizes)
    for i in sorted(range(len(sizes)), key=lambda i: (-int(sizes[i]), i)):
        r = min(range(SHARD_WORLD), key=lambda r: (loads[r], r))
        owners[i] = r
        loads[r] += max(int(sizes[i]), 1)
    return owners


def check_k2_owned(torch, k_entropy, counts, offsets, n_rows, segments):
    """K2's owned-segment launch: bitwise equal to the all-segment launch's
    values for those segments, and within 1e-12 relative of its plain
    version. Returns the max |err| against the plain version."""
    seg = torch.as_tensor(np.asarray(segments, np.int64),
                          device=counts.device)
    full = k_entropy.entropy_terms(counts, offsets, n_rows)
    got = k_entropy.entropy_terms_owned(counts, offsets, n_rows, segments)
    plain = k_entropy.entropy_terms_owned_plain(counts, offsets, n_rows,
                                                segments)
    torch.cuda.synchronize()
    for g, f in zip(got, full):
        if not torch.equal(g, f[seg]):
            fail(f"K2's owned-segment launch differs from the full launch "
                 f"on segments {list(segments)[:8]}... of {len(offsets) - 1}")
    if not (torch.equal(got[1], plain[1]) and torch.equal(got[2], plain[2])):
        fail("K2's owned-segment totals differ from its plain version")
    if not torch.allclose(got[0], plain[0], rtol=1e-12, atol=0.0):
        fail("K2's owned-segment entropies outside 1e-12 of the plain")
    return float((got[0] - plain[0]).abs().max().item()) \
        if got[0].numel() else 0.0


def k2_owned_bound_ms(counts, offsets, segments):
    """(bytes ms, operations ms) of an owned-segment K2 launch: the owned
    segments' counts read once, their (start, end, chunk base) table and
    (h, total, nnz) written; f64 work on their nonzero counts."""
    off = np.asarray(offsets, np.int64)
    segs = np.asarray(segments, np.int64)
    cells = sum(int(off[s + 1] - off[s]) for s in segs)
    nnz = sum(int((counts[int(off[s]):int(off[s + 1])] > 0).sum().item())
              for s in segs)
    bytes_ms = 1e3 * (4 * cells + 24 * len(segs) + 8 + 24 * len(segs)) \
        / HBM_BYTES_PER_S
    return bytes_ms, 1e3 * K2_OPS_PER_NONZERO * nnz / FP64_OPS_PER_S


def k2_owned_bare(torch, k_entropy, build, counts, offsets, n_rows,
                  segments):
    """One owned-segment K2 launch through ctypes alone (packed once)."""
    import ctypes
    t, outs = k_entropy.pack_table(counts, offsets, n_rows, segments)
    lib, stream = build.library(), build.current_stream()

    def launch():
        build.check(lib.delphi_entropy_terms(ctypes.addressof(t), stream),
                    "entropy_terms")
    launch.keep = (t, outs)
    return launch


def measure_k2_owned(torch, k_entropy, build, flush, counts, offsets, n_rows,
                     segments, label):
    bytes_ms, ops_ms = k2_owned_bound_ms(counts, offsets, segments)
    fn = lambda: k_entropy.entropy_terms_owned(  # noqa: E731
        counts, offsets, n_rows, segments)
    row = {
        "ms": time_ms(torch, fn, flush),
        "host_ms": host_ms(torch, fn),
        "plain_ms": time_ms(torch, lambda: k_entropy.entropy_terms_owned_plain(
            counts, offsets, n_rows, segments), flush),
        "library_ms": None,
        "bytes_ms": bytes_ms, "ops_ms": ops_ms,
        "bound_ms": max(bytes_ms, ops_ms),
    }
    defer_kernel_ms(f"K2 owned {label}", row, fn,
                    k2_owned_bare(torch, k_entropy, build, counts, offsets,
                                  n_rows, segments),
                    ["entropy_terms_kernel"], 1)
    return row


def check_k5_split(torch, k_domain, call, groups):
    """A recorded weak-label K5 launch split by group owner into one launch
    per rank (each over its own groups' pieces): every cell's (has_domain,
    top) equals the full launch's, so the OR of the ranks' demote masks is
    the full mask. ``groups`` names each piece's group. Returns the cells
    each rank's launch scored."""
    from delphi_tpu_torch.ops.kernels.domain_scores import Operands, pack
    mode, ops, beta, n_rows, _ = call
    lay = ops.layout
    full_has, full_top = k_domain.split_weak(
        k_domain.weak_label(ops, beta, n_rows), lay.cells)
    # the host copy of each piece's operands, from the launch's blob
    pieces = unpack_pieces(k_domain, ops)
    sizes = {}
    for g, (m, _) in zip(groups, lay.extents):
        sizes[g] = sizes.get(g, 0) + m
    names = sorted(sizes)
    owner = dict(zip(names, owners_of([sizes[g] for g in names])))
    starts = np.concatenate([[0], np.cumsum([m for m, _ in lay.extents])])
    cells = []
    for r in range(SHARD_WORLD):
        mine = [i for i, g in enumerate(groups) if owner[g] == r]
        if not mine:
            cells.append(0)
            continue
        blob, layout = pack([pieces[i] for i in mine], lay.vc_pad)
        sub = Operands(ops.codes, torch.as_tensor(blob, device=ops.device),
                       layout)
        has, top = k_domain.split_weak(k_domain.weak_label(sub, beta, n_rows),
                                       layout.cells)
        at = 0
        for i in mine:
            m = lay.extents[i][0]
            lo = int(starts[i])
            if not (torch.equal(has[at:at + m], full_has[lo:lo + m])
                    and torch.equal(top[at:at + m], full_top[lo:lo + m])):
                fail(f"K5: rank {r}'s launch over its groups differs from "
                     f"the full launch on piece {i} of {lay}")
            at += m
        cells.append(at)
    return cells


def unpack_pieces(k_domain, ops):
    """The k_domain.Piece of each piece of a launch, read back from its
    operands on the host."""
    lay = ops.layout
    off = ops.cell_off.cpu().numpy()
    rows = ops.rows.cpu().numpy()
    out = []
    for i, (m, v_a) in enumerate(lay.extents):
        out.append(k_domain.Piece(
            rows=rows[off[i]:off[i] + m].astype(np.int64),
            col_idx=ops.col_idx[i].cpu().numpy(),
            taus=ops.taus[i].cpu().numpy(),
            vcs=ops.vcs[i].cpu().numpy(),
            hs=ops.hs[i, :v_a].cpu().numpy().astype(bool),
            rank=ops.rank[i, :v_a].cpu().numpy(),
            tables=ops.tables[i].cpu().numpy()))
    return out


def shard_kernel_checks(torch, k_pair, k_entropy, k_domain, recorded,
                        k5_groups) -> dict:
    """4m(d): on 4's and 4f's recorded inputs, K2's owned-segment launch
    over each rank's pairs bitwise equal to the full launch; the int64 sum
    of the two half spans' K1 counts equal to the full table's; 4's K5
    weak-label launches split by group owner equal to the full launch."""
    out = {}
    for path in ("e2e", "constraints"):
        checked = 0
        for counts, offsets, n_rows in recorded[path]["entropy_terms"]:
            sizes = np.diff(offsets)
            if len(sizes) < 2:
                continue
            owners = owners_of(sizes)
            for r in range(SHARD_WORLD):
                segs = [s for s, o in enumerate(owners) if o == r]
                if segs:
                    check_k2_owned(torch, k_entropy, counts, offsets, n_rows,
                                   segs)
                    checked += 1
        out[f"k2_owned_{path}"] = checked
        if not checked:
            fail(f"4m(d): no K2 input of path {path} with two segments")
    codes, pairs, vocab = recorded["e2e"]["pair_counts"][0]
    n = int(codes.shape[1])
    full, off = k_pair.pair_counts(codes, pairs, vocab)
    total = torch.zeros_like(full, dtype=torch.int64)
    for lo, hi in ((0, n // 2), (n // 2, n)):
        part, part_off = k_pair.pair_counts(codes[:, lo:hi].contiguous(),
                                            pairs, vocab)
        if not np.array_equal(part_off, off):
            fail("4m(d): K1's span offsets differ from the full table's")
        total += part.long()
    torch.cuda.synchronize()
    if not torch.equal(total, full.long()):
        fail("4m(d): the int64 sum of K1's span counts differs from the "
             "full table's")
    out["k1_span_sum"] = {"rows": n, "pairs": len(pairs)}
    split = []
    for call, groups in zip(recorded["e2e"]["domain_scores"], k5_groups):
        if call[0] == "weak":
            split.append(check_k5_split(torch, k_domain, call, groups))
    if not split:
        fail("4m(d): no weak-label K5 launch of 4 to split")
    out["k5_split_cells"] = split
    return out


def rank_gbdt_held(torch, rec, label):
    """A rank's recorded K3 / K4 calls (:func:`shard_rank`) held bitwise
    against the plain versions on the card (:func:`gbdt_hold`); None when
    it recorded none."""
    from delphi_tpu_torch.ops.kernels import gbdt as k_gbdt
    if not rec["gbdt"]:
        return None
    held, _ = gbdt_hold(torch, k_gbdt, rec["gbdt"], label)
    log(f"[{label}] K3 / K4 calls of distinct structure, each bitwise "
        f"equal to its plain version: {json.dumps(held)}")
    return held


def shard_plane(torch, T, build, flush, k_pair, k_entropy, k_domain,
                recorded, k5_groups, out_e2e, plans_frame) -> dict:
    """Phase 4m (module docstring). Returns the per-rank kernel rows for the
    kernels line and the phase's summary."""
    import shutil
    import tempfile
    work = tempfile.mkdtemp(prefix="delphi_shard_")
    res = {}
    try:
        # (a) + (b): one cluster: 4's 1M table at 4's options (inputs
        # recorded), then PLAN_ROWS rows twice with a per-rank plan store
        t0 = time.perf_counter()
        runs = [{"rows": E2E_ROWS, "seed": 0, "options": {}, "record": True},
                {"rows": PLAN_ROWS, "seed": 12, "options": PLAN_OPTIONS,
                 "plans": True},
                {"rows": PLAN_ROWS, "seed": 12, "options": PLAN_OPTIONS,
                 "plans": True, "report": True}]
        codes, outs, results = shard_cluster(work, "parity", runs)
        wall = time.perf_counter() - t0
        if codes != [0] * SHARD_WORLD or None in results:
            fail(f"4m(a): rank exit codes {codes}\n" + "\n".join(
                f"--- rank {r} ---\n{o[-3000:]}" for r, o in enumerate(outs)))
        for r, rank_runs in enumerate(results):
            if not shard_frame(work, "parity", 0, r).equals(out_e2e):
                fail(f"4m(a): rank {r}'s 1M frame differs from 4's")
            for i in (1, 2):
                if not shard_frame(work, "parity", i, r).equals(plans_frame):
                    fail(f"4m(b): rank {r}'s run {i} frame differs from "
                         "4l(c)'s")
            a, cold, warm = rank_runs
            c = a["counters"]
            if c.get("shard.merges", 0) < 1 or c.get("shard.degraded", 0):
                fail(f"4m(a): rank {r} merges {c.get('shard.merges')}, "
                     f"degraded {c.get('shard.degraded')}")
            if fault_counts(c):
                fail(f"4m(a): rank {r} counted faults {fault_counts(c)}")
            for name in ("pair_counts", "entropy_terms_owned",
                         "domain_scores_weak"):
                if a["launches"][name] < 1:
                    fail(f"4m(a): rank {r} did not launch {name}")
            w = warm["counters"]
            if w.get("launch.replans", 0) != 0 \
                    or w.get("launch.plan_cache.hits", 0) < 1:
                fail(f"4m(b): rank {r}'s warm run replans "
                     f"{w.get('launch.replans')}, hits "
                     f"{w.get('launch.plan_cache.hits')}")
            res[f"rank{r}"] = {
                "wall_s": a["wall_s"], "phase_walls": a["phase_walls"],
                "shard_rows": a["shard_rows"], "launches": a["launches"],
                "merges": c.get("shard.merges"), "spans": c.get("shard.spans"),
                "bytes_sent": c.get("dist.bytes_sent"),
                "launch_phase": {k: v for k, v in c.items()
                                 if k.startswith("launch.phase.")},
                "warm": {k: w.get(k, 0) for k in ("launch.plan_cache.hits",
                                                  "launch.replans")},
                "warm_wall_s": warm["wall_s"], "cold_wall_s": cold["wall_s"]}
            log(f"[shard] (a) rank {r} of {SHARD_WORLD}, {E2E_ROWS} rows on "
                f"one card: {json.dumps(res[f'rank{r}'])}")
        res["cluster_wall_s"] = wall
        res["reports"] = shard_reports(work, [r[2] for r in results])
        log(f"[shard] (a) both ranks' 1M frames equal 4's, (b) their "
            f"{PLAN_ROWS}-row warm runs replan nothing and equal 4l(c)'s "
            f"frame; the cluster's wall {wall:.1f} s with process start "
            "(two ranks share the card: contention, not scaling)")

        # (c) death: rank 1 exits at its first frequency merge
        t0 = time.perf_counter()
        ckpt = os.path.join(work, "death_ckpt")
        codes, outs, results = shard_cluster(
            work, "death", [{"rows": PLAN_ROWS, "seed": 12,
                             "options": PLAN_OPTIONS}],
            {"DELPHI_FAULT_PLAN": SHARD_DEATH_PLAN,
             "DELPHI_CHECKPOINT_DIR": ckpt,
             "DELPHI_COLLECTIVE_TIMEOUT_S": "60"})
        if codes != [0, 17] or results[0] is None:
            fail(f"4m(c): rank exit codes {codes} (want [0, 17])\n"
                 + "\n".join(f"--- rank {r} ---\n{o[-3000:]}"
                             for r, o in enumerate(outs)))
        if not shard_frame(work, "death", 0, 0).equals(plans_frame):
            fail("4m(c): the survivor's frame differs from 4l(c)'s")
        c = results[0][0]["counters"]
        death = {k: c.get(k, 0) for k in (
            "resilience.dist.rank_loss", "resilience.dist.single_host_latch",
            "shard.degraded", "shard.merges")}
        if death["resilience.dist.rank_loss"] < 1 \
                or death["resilience.dist.single_host_latch"] < 1 \
                or death["shard.degraded"] < 1 \
                or not os.path.exists(os.path.join(ckpt, "rank_loss.json")):
            fail(f"4m(c): survivor counters {death}, marker "
                 f"{os.listdir(ckpt) if os.path.isdir(ckpt) else None}")
        res["death"] = {**death, "wall_s": results[0][0]["wall_s"],
                        "cluster_wall_s": time.perf_counter() - t0}
        log(f"[shard] (c) {SHARD_DEATH_PLAN} at {PLAN_ROWS} rows: rank 1 "
            f"exit 17, rank 0 exit 0 with 4l(c)'s frame, rank_loss.json "
            f"written; {json.dumps(res['death'])}")

        # (d) kernel checks, then each rank's recorded inputs held against
        # the plain versions and timed
        res["checks"] = shard_kernel_checks(torch, k_pair, k_entropy,
                                            k_domain, recorded, k5_groups)
        log(f"[shard] (d) K2 owned-segment launches bitwise equal to the "
            f"full ones, K1's span sums equal, K5 split by owner equal: "
            f"{json.dumps(res['checks'])}")
        from delphi_tpu_torch.ops.kernels.domain_scores import Operands
        rows = {}
        for r in range(SHARD_WORLD):
            rec = torch.load(os.path.join(work, f"parity.inputs.r{r}.pt"),
                             weights_only=False)
            k1, k2, k2o, k5 = [], [], [], []
            errs = {"pair_counts": 0, "entropy_terms": 0.0,
                    "entropy_terms_owned": 0.0, "domain_scores_weak": 0}
            for codes_c, pairs, vocab in rec["pair_counts"]:
                codes_d = codes_c.cuda()
                _, _, err = check_k1(torch, k_pair, codes_d, pairs, vocab)
                errs["pair_counts"] = max(errs["pair_counts"], err)
                k1.append(measure_k1(torch, k_pair, build, flush, codes_d,
                                     pairs, vocab, f"shard r{r}"))
            for counts_c, offsets, n_rows in rec["entropy_terms"]:
                counts_d = counts_c.cuda()
                errs["entropy_terms"] = max(
                    errs["entropy_terms"],
                    check_k2(torch, k_entropy, counts_d, offsets, n_rows))
                k2.append(measure_k2(torch, k_entropy, build, flush, counts_d,
                                     offsets, n_rows, f"shard r{r}"))
            for counts_c, offsets, n_rows, segs in rec["entropy_owned"]:
                counts_d = counts_c.cuda()
                errs["entropy_terms_owned"] = max(
                    errs["entropy_terms_owned"],
                    check_k2_owned(torch, k_entropy, counts_d, offsets,
                                   n_rows, segs))
                k2o.append(measure_k2_owned(
                    torch, k_entropy, build, flush, counts_d, offsets,
                    n_rows, segs, f"shard r{r}"))
            for codes_c, blob, layout, beta, n_rows, extents in \
                    rec["weak_label"]:
                ops = Operands(codes_c.cuda(), blob.cuda(), layout)
                call = ("weak", ops, beta, n_rows, extents)
                errs["domain_scores_weak"] = max(
                    errs["domain_scores_weak"], check_k5(torch, k_domain,
                                                         call))
                k5.append(measure_k5(torch, k_domain, build, flush, call,
                                     f"shard r{r}"))
            if not (k1 and k2o and k5):
                fail(f"4m: rank {r} recorded no K1, owned K2 or K5 input")
            rows[r] = {"pair_counts": k1, "entropy_terms": k2,
                       "entropy_terms_owned": k2o,
                       "domain_scores_weak": k5, "errs": errs,
                       "gbdt_held": rank_gbdt_held(torch, rec,
                                                   f"4m(d) rank {r}")}
        res["rows"] = rows
        return res
    finally:
        shutil.rmtree(work, ignore_errors=True)


# -- 4o: the device mesh ------------------------------------------------------

# the JAX package's bound on the repairs that a mesh run may change
# against the one-process run (tests/test_distributed.py)
MESH_REPAIR_DIFF = 0.02


def mesh_summary(run: dict) -> dict:
    """What 4o prints of one rank's run: the wall, the phase walls and the
    mesh reductions with their bytes and seconds."""
    c = run["counters"]
    return {"wall_s": run["wall_s"], "phase_walls": run["phase_walls"],
            "reductions": c.get("mesh.reductions", 0),
            "bytes_sent": c.get("mesh.bytes_sent", 0),
            "reduce_s": run["mesh_reduce_s"], "launches": run["launches"]}


def mesh_plane(torch, T, build, flush, k_pair, k_entropy, k_domain, out_e2e,
               plans_frame) -> dict:
    """Phase 4o (module docstring). Returns the per-rank kernel rows for
    the kernels line and the phase's summary."""
    import shutil
    import tempfile
    work = tempfile.mkdtemp(prefix="delphi_mesh_")
    res = {}
    try:
        # (a) 4's 1M table on a two-rank cluster's default mesh (inputs
        # recorded), then (b)'s CHECK_ROWS rows on the card
        t0 = time.perf_counter()
        runs = [{"rows": E2E_ROWS, "seed": 0, "options": {}, "record": True},
                {"rows": CHECK_ROWS, "seed": 1, "options": {}}]
        codes, outs, results = shard_cluster(work, "mesh", runs,
                                             rank_env={})
        wall = time.perf_counter() - t0
        if codes != [0] * SHARD_WORLD or None in results:
            fail(f"4o(a): rank exit codes {codes}\n" + "\n".join(
                f"--- rank {r} ---\n{o[-3000:]}" for r, o in enumerate(outs)))
        frame0 = shard_frame(work, "mesh", 0, 0)
        for r, rank_runs in enumerate(results):
            for i in (0, 1):
                if not shard_frame(work, "mesh", i, r).equals(
                        shard_frame(work, "mesh", i, 0)):
                    fail(f"4o: rank {r}'s run {i} frame differs from rank "
                         "0's")
            c = rank_runs[0]["counters"]
            bad = {k: v for k, v in c.items()
                   if k.startswith("shard.") or k in fault_counts(c)}
            if bad:
                fail(f"4o(a): rank {r} counted faults or shard merges: "
                     f"{bad}")
            for name in ("pair_counts", "entropy_terms", "domain_scores_int",
                         *GBDT_KERNELS):
                if rank_runs[0]["launches"][name] < 1:
                    fail(f"4o(a): rank {r} did not launch {name}")
            if c.get("mesh.reductions", 0) < 1:
                fail(f"4o(a): rank {r} made no mesh reduction")
            res[f"rank{r}"] = mesh_summary(rank_runs[0])
            log(f"[mesh] (a) rank {r} of {SHARD_WORLD}, {E2E_ROWS} rows on "
                f"one card, default mesh: {json.dumps(res[f'rank{r}'])}")
        cells = frame0[["tid", "attribute"]].reset_index(drop=True)
        if not cells.equals(out_e2e[["tid", "attribute"]]
                            .reset_index(drop=True)):
            fail("4o(a): the mesh run's error cells differ from 4's")
        differ = int((frame0["repaired"].astype(str).to_numpy()
                      != out_e2e["repaired"].astype(str).to_numpy()).sum())
        if differ > MESH_REPAIR_DIFF * len(out_e2e):
            fail(f"4o(a): {differ} of {len(out_e2e)} repairs differ from "
                 f"4's, more than {MESH_REPAIR_DIFF:.0%}")
        res["a"] = {"repairs": len(out_e2e), "differ": differ,
                    "cluster_wall_s": wall}
        log(f"[mesh] (a) both ranks' 1M frames equal; error cells equal "
            f"4's, {differ} of {len(out_e2e)} repairs differ from 4's "
            f"(gate {MESH_REPAIR_DIFF:.0%}); the cluster's wall {wall:.1f} "
            "s with process start (two ranks share the card: contention "
            "and the reductions' cost, not scaling)")

        # (b) the same CHECK_ROWS run on a two-rank cluster on the CPU
        t0 = time.perf_counter()
        codes, outs, results_cpu = shard_cluster(
            work, "mesh_cpu", [runs[1]],
            rank_env={"DELPHI_TORCH_DEVICE": "cpu"})
        if codes != [0] * SHARD_WORLD or None in results_cpu:
            fail(f"4o(b): CPU rank exit codes {codes}\n" + "\n".join(
                f"--- rank {r} ---\n{o[-3000:]}" for r, o in enumerate(outs)))
        card = shard_frame(work, "mesh", 1, 0)
        for r in range(SHARD_WORLD):
            if not shard_frame(work, "mesh_cpu", 0, r).equals(card):
                fail(f"4o(b): CPU cluster rank {r}'s {CHECK_ROWS}-row frame "
                     "differs from the card cluster's")
        res["b"] = {"rows": CHECK_ROWS, "repairs": len(card),
                    "cpu": mesh_summary(results_cpu[0][0]),
                    "card": mesh_summary(results[0][1]),
                    "cluster_wall_s": time.perf_counter() - t0}
        log(f"[mesh] (b) {CHECK_ROWS} rows: the CPU cluster's frames equal "
            f"the card cluster's ({len(card)} repairs); "
            f"{json.dumps(res['b'])}")

        # (c) one process with DELPHI_MESH=1 (a one-slot mesh) on 4l(c)'s
        # table: the unmeshed run's frame
        from delphi_tpu_torch.parallel import mesh as t_mesh
        _, plan_df = missing_heavy(PLAN_ROWS, seed=12)
        os.environ["DELPHI_MESH"] = "1"
        t_mesh._active_mesh_cache.clear()
        try:
            t0 = time.perf_counter()
            one = repair(T, plan_df, options=PLAN_OPTIONS)
            torch.cuda.synchronize()
            one_wall = time.perf_counter() - t0
        finally:
            del os.environ["DELPHI_MESH"]
            t_mesh._active_mesh_cache.clear()
        if not one.equals(plans_frame):
            fail("4o(c): the one-slot mesh's frame differs from 4l(c)'s")
        res["c"] = {"rows": PLAN_ROWS, "wall_s": one_wall}
        log(f"[mesh] (c) DELPHI_MESH=1 in one process, {PLAN_ROWS} rows: "
            f"4l(c)'s frame in {one_wall:.3f} s")

        # (d) each rank's recorded inputs held against the plain versions
        # and timed
        from delphi_tpu_torch.ops.kernels.domain_scores import Operands
        rows = {}
        for r in range(SHARD_WORLD):
            rec = torch.load(os.path.join(work, f"mesh.inputs.r{r}.pt"),
                             weights_only=False)
            k1, k2, k5 = [], [], []
            errs = {"pair_counts": 0, "entropy_terms": 0.0,
                    "domain_scores_int": 0}
            for codes_c, pairs, vocab in rec["pair_counts"]:
                codes_d = codes_c.cuda()
                _, _, err = check_k1(torch, k_pair, codes_d, pairs, vocab)
                errs["pair_counts"] = max(errs["pair_counts"], err)
                k1.append(measure_k1(torch, k_pair, build, flush, codes_d,
                                     pairs, vocab, f"mesh r{r}"))
            for counts_c, offsets, n_rows in rec["entropy_terms"]:
                counts_d = counts_c.cuda()
                errs["entropy_terms"] = max(
                    errs["entropy_terms"],
                    check_k2(torch, k_entropy, counts_d, offsets, n_rows))
                k2.append(measure_k2(torch, k_entropy, build, flush, counts_d,
                                     offsets, n_rows, f"mesh r{r}"))
            for codes_c, blob, layout, extents in rec["domain_scores"]:
                ops = Operands(codes_c.cuda(), blob.cuda(), layout)
                call = ("int", ops, None, None, extents)
                errs["domain_scores_int"] = max(
                    errs["domain_scores_int"],
                    check_k5(torch, k_domain, call))
                k5.append(measure_k5(torch, k_domain, build, flush, call,
                                     f"mesh r{r}"))
            if not (k1 and k2 and k5):
                fail(f"4o(d): rank {r} recorded no K1, K2 or K5 input")
            held = rank_gbdt_held(torch, rec, f"4o(d) rank {r}")
            if not held or not all(h["calls_checked"]
                                   for h in held.values()):
                fail(f"4o(d): rank {r} recorded no call of a GBDT kernel: "
                     f"{held}")
            rows[r] = {"pair_counts": k1, "entropy_terms": k2,
                       "domain_scores_int": k5, "errs": errs,
                       "gbdt_held": held}
            log(f"[mesh] (d) rank {r}: {len(k1)} K1, {len(k2)} K2 and "
                f"{len(k5)} K5 integer-mode inputs equal to their plain "
                f"versions (max |err| {json.dumps(errs)})")
        res["rows"] = rows
        return res
    finally:
        shutil.rmtree(work, ignore_errors=True)


# -- 4p: process-local tables ---------------------------------------------

# 4p's chunk sizes: ten chunks of the 1M table, ten of (b)'s table
PL_CHUNK_ROWS = 100_000
PL_DC_ROWS = 200_000
PL_DC_CHUNK_ROWS = 20_000
# the share of repairs a process-local cluster may change against one
# process (the JAX package's test_two_process_sharded_pipeline bound)
PL_REPAIR_DIFF = 0.05
PL_DC_DTYPES = {"tid": "str", "city": "str", "state": "str",
                "region": "str", "channel": "str", "amount": "float64"}


def _proc_kb(path: str, key: str):
    with open(path) as f:
        for line in f:
            if line.startswith(key + ":"):
                return int(line.split()[1])
    return None


def host_rss_gb():
    """This process's resident set (GB), from /proc."""
    kb = _proc_kb("/proc/self/status", "VmRSS")
    return None if kb is None else round(kb / 2**20, 2)


def host_available_gb():
    """The host's available memory (GB), from /proc."""
    kb = _proc_kb("/proc/meminfo", "MemAvailable")
    return None if kb is None else round(kb / 2**20, 2)


def _pl_dtypes(spec):
    """The ``dtype`` argument of a 4p read: ``str``, or a dict of column
    types ("str" meaning ``str``; the spec travels as JSON)."""
    return str if spec == "str" else {
        k: (str if v == "str" else v) for k, v in spec.items()}


def process_local_plane(torch, T, build, flush, k_pair, k_entropy,
                        dirty) -> dict:
    """Phase 4p (module docstring). Returns the per-rank kernel rows for
    the kernels line and the phase's summary."""
    import shutil
    import tempfile

    import pandas as pd
    from delphi_tpu_torch.ingest import read_csv_encoded
    work = tempfile.mkdtemp(prefix="delphi_pl_")
    res = {}
    key = ["tid", "attribute"]
    # the two ranks share the card with this process: hand back its
    # cached blocks first, and log the host's and the card's headroom
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[process-local] before the ranks: this process {host_rss_gb()} "
        f"GB RSS, the host {host_available_gb()} GB available, the card "
        f"{torch.cuda.memory_reserved() / 2**30:.2f} GB reserved")
    try:
        t0 = time.perf_counter()
        csv_a = os.path.join(work, "missing_heavy.csv")
        dirty.to_csv(csv_a, index=False)
        csv_b = os.path.join(work, "fd_table.csv")
        _, dc_dirty, _ = fd_table(PL_DC_ROWS, seed=4)
        dc_dirty.to_csv(csv_b, index=False)
        log(f"[process-local] wrote {len(dirty)} + {PL_DC_ROWS} rows to CSV "
            f"in {time.perf_counter() - t0:.1f} s")
        runs = [{"csv": csv_a, "rows": len(dirty), "chunksize": PL_CHUNK_ROWS,
                 "dtype": "str", "options": {}, "record": True},
                {"csv": csv_b, "rows": PL_DC_ROWS,
                 "chunksize": PL_DC_CHUNK_ROWS, "dtype": PL_DC_DTYPES,
                 "detectors": "dc", "detect_only": True, "options": {}}]
        t0 = time.perf_counter()
        codes, outs, results = shard_cluster(work, "pl", runs, rank_env={})
        wall = time.perf_counter() - t0
        if codes != [0] * SHARD_WORLD or None in results:
            fail(f"4p: rank exit codes {codes}\n" + "\n".join(
                f"--- rank {r} ---\n{o[-3000:]}" for r, o in enumerate(outs)))

        # the one-process runs of the same CSVs on the card
        T.set_device("cuda")
        table = read_csv_encoded(csv_a, "tid", chunksize=PL_CHUNK_ROWS,
                                 dtype=str)
        T.delphi.register_table("pl_one", table)
        m = T.delphi.repair.setTableName("pl_one").setRowId("tid") \
            .setErrorDetectors([T.NullErrorDetector()])
        for k, v in RUN_OPTIONS.items():
            m = m.option(k, v)
        t0 = time.perf_counter()
        one = m.run()
        torch.cuda.synchronize()
        one_wall = time.perf_counter() - t0
        dc_table = read_csv_encoded(csv_b, "tid", chunksize=PL_DC_CHUNK_ROWS,
                                    dtype=_pl_dtypes(PL_DC_DTYPES))
        T.delphi.register_table("pl_dc_one", dc_table)
        dc_one = T.delphi.repair.setTableName("pl_dc_one").setRowId("tid") \
            .setTargets(DC_TARGETS).setErrorDetectors(dc_detectors(T)) \
            .run(detect_errors_only=True)

        # (a) the union of the ranks' cells is the one-process run's
        union = pd.concat([shard_frame(work, "pl", 0, r)
                           for r in range(SHARD_WORLD)], ignore_index=True)
        union = union.sort_values(key).reset_index(drop=True)
        one = one.sort_values(key).reset_index(drop=True)
        if len(union) != len(one) or not union[key].equals(one[key]):
            fail(f"4p(a): the ranks' {len(union)} error cells are not the "
                 f"one-process run's {len(one)}")
        differ = int((union["repaired"].astype(str).to_numpy()
                      != one["repaired"].astype(str).to_numpy()).sum())
        if differ > PL_REPAIR_DIFF * len(one):
            fail(f"4p(a): {differ} of {len(one)} repairs differ from the "
                 f"one-process run's, more than {PL_REPAIR_DIFF:.0%}")
        for r, rank_runs in enumerate(results):
            a = rank_runs[0]
            if a["cuda_payloads"] or rank_runs[1]["cuda_payloads"]:
                fail(f"4p: rank {r} gathered {a['cuda_payloads']} payloads "
                     "holding a CUDA tensor")
            for name in ("pair_counts", "entropy_terms"):
                if a["launches"][name] < 1:
                    fail(f"4p(a): rank {r} did not launch {name}")
            bad = fault_counts(a["counters"])
            if bad:
                fail(f"4p(a): rank {r} counted faults: {bad}")
            res[f"rank{r}"] = {
                "local_rows": a["local_rows"], "wall_s": a["wall_s"],
                "ingest_s": a["ingest_s"], "gathers": a["gathers"],
                "domain_s": a["phase_walls"].get("cell domain analysis"),
                "phase_walls": a["phase_walls"], "launches": a["launches"],
                "mesh_reductions": a["counters"].get("mesh.reductions", 0)}
            log(f"[process-local] (a) rank {r} of {SHARD_WORLD}: "
                f"{json.dumps(res[f'rank{r}'])}")
        res["a"] = {"repairs": len(one), "differ": differ,
                    "one_process_wall_s": one_wall, "cluster_wall_s": wall}
        log(f"[process-local] (a) the ranks' {len(union)} error cells equal "
            f"one read_csv_encoded run's; {differ} of {len(one)} repairs "
            f"differ (gate {PL_REPAIR_DIFF:.0%}); one process {one_wall:.3f} "
            f"s, the cluster {wall:.1f} s with process start and ingestion "
            "(two ranks share the card)")

        # (b) the union of the ranks' detections is the one-process run's
        det = pd.concat([shard_frame(work, "pl", 1, r)
                         for r in range(SHARD_WORLD)], ignore_index=True)
        det = det.sort_values(key).reset_index(drop=True)
        dc_one = dc_one.sort_values(key).reset_index(drop=True)
        if not det[dc_one.columns].astype(str).equals(dc_one.astype(str)):
            fail(f"4p(b): the ranks' {len(det)} detections are not the "
                 f"one-process run's {len(dc_one)}")
        res["b"] = {"rows": PL_DC_ROWS, "detections": len(dc_one),
                    "rank_walls_s": [rr[1]["wall_s"] for rr in results],
                    "detect_counts": [
                        {k: v for k, v in rr[1]["counters"].items()
                         if k.startswith("detect.")} for rr in results]}
        log(f"[process-local] (b) fd_table at {PL_DC_ROWS} rows, four "
            f"detectors: the ranks' {len(det)} detections equal the "
            f"one-process run's; {json.dumps(res['b'])}")

        # (a) each rank's K1 and K2 inputs held against the plain versions
        # and timed
        rows = {}
        for r in range(SHARD_WORLD):
            rec = torch.load(os.path.join(work, f"pl.inputs.r{r}.pt"),
                             weights_only=False)
            k1, k2 = [], []
            errs = {"pair_counts": 0, "entropy_terms": 0.0}
            for codes_c, pairs, vocab in rec["pair_counts"]:
                codes_d = codes_c.cuda()
                _, _, err = check_k1(torch, k_pair, codes_d, pairs, vocab)
                errs["pair_counts"] = max(errs["pair_counts"], err)
                k1.append(measure_k1(torch, k_pair, build, flush, codes_d,
                                     pairs, vocab, f"process-local r{r}"))
            for counts_c, offsets, n_rows in rec["entropy_terms"]:
                counts_d = counts_c.cuda()
                errs["entropy_terms"] = max(
                    errs["entropy_terms"],
                    check_k2(torch, k_entropy, counts_d, offsets, n_rows))
                k2.append(measure_k2(torch, k_entropy, build, flush, counts_d,
                                     offsets, n_rows, f"process-local r{r}"))
            if not (k1 and k2):
                fail(f"4p(a): rank {r} recorded no K1 or K2 input")
            if any(c.shape[1] != results[r][0]["local_rows"]
                   for c, _, _ in rec["pair_counts"]):
                fail(f"4p(a): rank {r}'s K1 did not count its "
                     f"{results[r][0]['local_rows']} local rows")
            rows[r] = {"pair_counts": k1, "entropy_terms": k2, "errs": errs,
                       "gbdt_held": rank_gbdt_held(torch, rec,
                                                   f"4p(a) rank {r}")}
            log(f"[process-local] (a) rank {r}: {len(k1)} K1 inputs over "
                f"its {results[r][0]['local_rows']} rows and {len(k2)} K2 "
                "inputs on the global counts equal to their plain versions "
                f"(max |err| {json.dumps(errs)})")
        res["rows"] = rows
        return res
    finally:
        shutil.rmtree(work, ignore_errors=True)


# -- 4q: the live plane ------------------------------------------------------

LIVE_ENV = {"DELPHI_METRICS_PORT": "0", "DELPHI_STALL_TIMEOUT_S": "60",
            "DELPHI_RESOURCE_SAMPLE_S": "0.5"}


def live_plane(torch, T, dirty, out_e2e, e2e_wall) -> dict:
    """Phase 4q (module docstring). Returns the phase's summary."""
    import threading
    import urllib.request
    from delphi_tpu_torch.observability import live
    planes, scraped, errors = [], {}, []
    orig_start = live.LivePlane.start

    def scrape(plane):
        # every endpoint once while the run is in flight
        try:
            for path in ("/healthz", "/metrics", "/report"):
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{plane.port}{path}",
                        timeout=30) as r:
                    body = r.read()
                    scraped[path] = {"status": r.status, "bytes": len(body),
                                     "phase": plane.recorder.current_phase}
                    if path == "/report":
                        scraped[path]["status_field"] = \
                            json.loads(body)["status"]
        except Exception as e:  # reported by the phase below
            errors.append(f"{type(e).__name__}: {e}")

    def start(plane):
        orig_start(plane)
        planes.append(plane)
        t = threading.Thread(target=scrape, args=(plane,),
                             name="smoke-live-scraper", daemon=True)
        t.start()
        planes.append(t)

    live.LivePlane.start = start
    os.environ.update(LIVE_ENV)
    try:
        T.set_device("cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        frame = repair(T, dirty)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        live.LivePlane.start = orig_start
        for k in LIVE_ENV:
            os.environ.pop(k, None)
    if len(planes) != 2:
        fail(f"4q: {len(planes) // 2} live planes started, one expected")
    plane, scraper = planes
    scraper.join(timeout=60)
    if errors or sorted(scraped) != ["/healthz", "/metrics", "/report"]:
        fail(f"4q: the endpoints answered {scraped}, errors {errors}")
    if any(v["status"] != 200 for v in scraped.values()) \
            or scraped["/report"]["status_field"] != "running":
        fail(f"4q: an endpoint answered {scraped}")
    if not frame.equals(out_e2e):
        fail("4q: the run's frame with the live plane differs from 4's")
    snap = plane.recorder.registry.snapshot()
    gauges, counts = snap["gauges"], snap["counters"]
    index = torch.cuda.current_device()
    if not gauges.get(f"device.{index}.bytes_in_use", 0) > 0:
        fail(f"4q: device.{index}.bytes_in_use is "
             f"{gauges.get(f'device.{index}.bytes_in_use')}")
    if counts.get("watchdog.stalls", 0):
        fail(f"4q: the watchdog counted {counts['watchdog.stalls']} stalls")
    alive = [t.name for t in threading.enumerate()
             if t.name in ("delphi-metrics-server", "delphi-watchdog",
                           "delphi-resource-sampler")]
    if alive or plane.threads:
        fail(f"4q: plane threads still alive after the run: {alive}")
    res = {"wall_s": wall, "e2e_wall_s": e2e_wall, "port": plane.port,
           "scraped": scraped,
           "device_bytes_in_use": gauges[f"device.{index}.bytes_in_use"],
           "device_peak_bytes_in_use": gauges.get("device.peak_bytes_in_use"),
           "rss_gb": gauges.get("process.rss_gb"),
           "jit_compile_seconds": snap["histograms"].get(
               "jit.compile_seconds")}
    log(f"[live] 4's 1M repair with the live plane: {wall:.3f} s against "
        f"4's {e2e_wall:.3f} s (the same process; no gain or cost claimed); "
        f"frame equal, endpoints served mid-run, no stall, every plane "
        f"thread joined: {json.dumps(res, default=str)}")
    return res


# -- 4r / 4s: the serving plane and the fleet --------------------------------

# 4r and 4s: three seeded missing_heavy tables (A, B, C) of SERVE_ROWS rows,
# each posted as JSON with RUN_OPTIONS, as a service user would post them
SERVE_ROWS = 100_000
SERVE_SEEDS = (10, 11, 12)
SERVE_FAULT_PLAN = "xfer.upload:1:transient,domain.bucket:1:fatal"
FLEET_KILL_SITE = "xfer.upload"
# 4s's six requests: x and z, then y under the kill plan beside x, then y
# and z again (x, y, z name 4r's tables A, B, C in the order the homes
# pick: y's home dies)
FLEET_ORDER = ("x", "z", "y", "x", "y", "z")


def as_table(frame) -> dict:
    """A frame as a /repair request's ``table`` (column -> JSON values)."""
    split = json.loads(frame.to_json(orient="split"))
    return {c: [row[i] for row in split["data"]]
            for i, c in enumerate(split["columns"])}


def served_records(frame) -> str:
    """What the server makes of ``run()``'s frame: sorted by all columns,
    ``to_json(orient="records")``, dumped as the response dumps it."""
    frame = frame.sort_values(list(frame.columns)).reset_index(drop=True)
    return json.dumps(json.loads(frame.to_json(orient="records")))


def http(port, path, body=None, timeout=600):
    """(status, decoded body, client seconds and bytes) of one call."""
    import urllib.error
    import urllib.request
    t0 = time.perf_counter()
    data = None if body is None else json.dumps(body).encode()
    t1 = time.perf_counter()
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=data,
        method="GET" if body is None else "POST",
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            status, raw = r.status, r.read()
    except urllib.error.HTTPError as e:
        status, raw = e.code, e.read()
    t2 = time.perf_counter()
    out = json.loads(raw) if raw[:1] == b"{" else raw.decode()
    t3 = time.perf_counter()
    return status, out, {"encode_s": t1 - t0, "round_trip_s": t2 - t1,
                         "decode_s": t3 - t2, "bytes_out": len(data or b""),
                         "bytes_in": len(raw)}


def registry_delta(before, after) -> dict:
    """Counters that moved, and each histogram's sum and count that moved,
    between two registry snapshots."""
    counts = {k: v - before["counters"].get(k, 0)
              for k, v in after["counters"].items()
              if v != before["counters"].get(k, 0)}
    hists = {}
    for k, h in after["histograms"].items():
        b = before["histograms"].get(k, {"sum": 0.0, "count": 0})
        if h["count"] != b["count"]:
            hists[k] = {"sum": h["sum"] - b["sum"],
                        "count": h["count"] - b["count"]}
    return {"counters": counts, "histograms": hists}


def serving_plane(torch, T, traced, path_launches) -> dict:
    """Phase 4r (module docstring). Returns the summary, and each table's
    payload and served frame (4s's references)."""
    import shutil
    import tempfile
    from delphi_tpu_torch.observability.serve import (
        RepairServer, table_fingerprint,
    )
    tables = [missing_heavy(SERVE_ROWS, seed=s)[1] for s in SERVE_SEEDS]
    payloads = [{"table": as_table(df), "row_id": "tid",
                 "options": dict(RUN_OPTIONS)} for df in tables]
    fps = [table_fingerprint(p["table"], "tid") for p in payloads]
    T.set_device("cuda")
    # the reference: one in-process run() of table A, and what the server
    # does to its frame (sort, to_json), timed on it
    ref, ref_wall, _, _, _ = timed_run(torch, lambda: repair(T, tables[0]))
    t0 = time.perf_counter()
    want_a = served_records(ref)
    respond_s = time.perf_counter() - t0
    cache = tempfile.mkdtemp(prefix="smoke_serve_")
    saved_cc = os.environ.get("DELPHI_COMPILE_CACHE_DIR")
    srv = RepairServer(port=0, workers=2, cache_dir=cache).start()
    resolve_s = []
    orig_resolve = srv._resolve_table

    def timed_resolve(payload):
        t = time.perf_counter()
        try:
            return orig_resolve(payload)
        finally:
            resolve_s.append(time.perf_counter() - t)

    srv._resolve_table = timed_resolve
    res, answered = {}, []

    def post(payload, rid, **extra):
        status, body, client = http(srv.port, "/repair",
                                    dict(payload, request_id=rid, **extra))
        answered.append((rid, status))
        return status, body, client

    def served(label, cases, faults_ok=False):
        """``cases`` as one traced main path: (results, summary)."""
        before = srv.recorder.registry.snapshot()
        n_resolve = len(resolve_s)
        out, wall, launches, _, walls, peak, _ = traced(
            label, cases, faults_ok=faults_ok)
        delta = registry_delta(before, srv.recorder.registry.snapshot())
        k5 = path_launches[label]["domain_scores"]
        summary = {"wall_s": wall,
                   "launches": {**launches, "domain_scores": k5},
                   "phase_walls": walls, "peak_mib": round(peak, 1),
                   "resolve_s": resolve_s[n_resolve:], "registry": delta}
        log(f"[{label}] {json.dumps(summary, default=str)}")
        return out, summary

    try:
        # 1. cold, solo
        (status, body, client), cold = served(
            "served", lambda: post(payloads[0], "cold-a"))
        if status != 200:
            fail(f"4r cold request answered {status}: {body}")
        got_a = json.dumps(body["frame"])
        if got_a != want_a:
            fail("4r: the served frame of table A differs from run()'s "
                 "sorted frame")
        hist = cold["registry"]["histograms"]
        request_s = hist["serve.request_seconds"]["sum"]
        queue_s = hist["serve.queue_wait_seconds"]["sum"]
        run_s = sum(cold["phase_walls"].values())
        split = {
            "client_json_encode_s": client["encode_s"],
            "http_round_trip_s": client["round_trip_s"],
            "client_json_decode_s": client["decode_s"],
            "request_bytes": client["bytes_out"],
            "response_bytes": client["bytes_in"],
            "server_request_s": request_s, "queue_wait_s": queue_s,
            "http_and_server_json_s":
                client["round_trip_s"] - request_s - queue_s,
            "fingerprint_and_encode_s": cold["resolve_s"][0],
            "run_phases_s": run_s,
            "response_sort_and_encode_s (on run()'s frame)": respond_s,
            "run_other_s": request_s - cold["resolve_s"][0] - run_s
            - respond_s}
        res["cold"] = {**cold, "split": split, "run_alone_wall_s": ref_wall}
        log(f"[served] cold request of {SERVE_ROWS} rows: "
            f"{client['round_trip_s']:.3f} s through HTTP against "
            f"{ref_wall:.3f} s for run() alone; frame equal to run()'s byte "
            f"for byte ({len(body['frame'])} repairs); split "
            f"{json.dumps(split)}")

        # 2. warm: (a) the phase checkpoints resume, (b) without them the
        # model checkpoint and the plan store
        before = srv.recorder.registry.snapshot()
        status, body, client = post(payloads[0], "warm-a")
        delta = registry_delta(before, srv.recorder.registry.snapshot())
        counts = delta["counters"]
        if status != 200 or json.dumps(body["frame"]) != want_a:
            fail(f"4r warm request answered {status} or another frame")
        if counts.get("serve.table_cache.hits", 0) != 1 \
                or counts.get("resilience.checkpoint.hits", 0) < 1:
            fail(f"4r warm request: no table-cache or checkpoint hit: "
                 f"{counts}")
        res["warm_resume"] = {"wall_s": client["round_trip_s"],
                              "counters": counts}
        shutil.rmtree(srv._ckpt_dir(fps[0]), ignore_errors=True)
        (status, body, client), warm = served(
            "served warm", lambda: post(payloads[0], "warm-a2"))
        counts = warm["registry"]["counters"]
        if status != 200 or json.dumps(body["frame"]) != want_a:
            fail(f"4r warm request answered {status} or another frame")
        if counts.get("serve.table_cache.hits", 0) != 1 \
                or counts.get("train.checkpoint_hits", 0) < 1 \
                or counts.get("launch.plan_cache.hits", 0) < 1 \
                or counts.get("launch.replans", 0) != 0:
            fail(f"4r warm request without phase checkpoints: want a "
                 f"table-cache, model-checkpoint and plan-store hit and no "
                 f"replan: {counts}")
        res["warm"] = {**warm, "client_wall_s": client["round_trip_s"]}
        log(f"[served] warm: {res['warm_resume']['wall_s']:.3f} s resuming "
            f"the phase checkpoints, {client['round_trip_s']:.3f} s without "
            f"them (table cache, model checkpoint, plan store hit, 0 "
            f"replans) against {res['cold']['split']['http_round_trip_s']:.3f}"
            f" s cold")

        # 3. two requests side by side: A cold again (its warm state
        # dropped), B under a scoped fault plan
        srv._evict_dirty(fps[0])
        shutil.rmtree(srv._ckpt_dir(fps[0]), ignore_errors=True)
        gate = threading.Barrier(2)
        pair = {}

        def side(tag, payload, **extra):
            gate.wait(timeout=60)
            pair[tag] = post(payload, f"pair-{tag}", **extra)

        def both():
            threads = [threading.Thread(target=side, args=("a", payloads[0])),
                       threading.Thread(target=side, args=("b", payloads[1]),
                                        kwargs={"fault_plan":
                                                SERVE_FAULT_PLAN})]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=600)
            return dict(pair)

        pair_res, conc = served("served concurrent", both, faults_ok=True)
        st_a, body_a, _ = pair_res["a"]
        st_b, body_b, _ = pair_res["b"]
        if st_a != 200 or json.dumps(body_a["frame"]) != want_a:
            fail(f"4r: the clean request beside a faulted one answered "
                 f"{st_a} or another frame than the solo request's")
        if st_b != 500 or body_b.get("kind") != "fatal":
            fail(f"4r: the faulted request answered {st_b}: {body_b}")
        with srv._lock:
            warm_fps = set(srv._tables)
        if fps[0] not in warm_fps or fps[1] in warm_fps \
                or os.path.exists(srv._models_dir(fps[1])):
            fail("4r: the faulted request's eviction touched the wrong state")
        res["concurrent"] = {**conc, "faulted": body_b}
        log(f"[served] concurrent: the clean frame equals the solo one, the "
            f"faulted request answered {st_b} kind {body_b['kind']}, only "
            f"its state evicted; wall {conc['wall_s']:.3f} s")

        # 4. D1 under serving: the CPU rung refused, one structured 500
        before = srv.recorder.registry.snapshot()
        status, body, _ = post(payloads[2], "oom-c", fault_plan=PLAN_LADDER)
        counts = registry_delta(before,
                                srv.recorder.registry.snapshot())["counters"]
        if status != 500 or body.get("kind") != "oom" \
                or counts.get("resilience.degrade.cpu_refused", 0) < 1:
            fail(f"4r: the oom plan answered {status} {body}, counters "
                 f"{counts}")
        res["oom"] = {"status": status, "kind": body["kind"],
                      "counters": counts}
        log(f"[served] oom plan: 500 kind oom, "
            f"resilience.degrade.cpu_refused "
            f"{counts['resilience.degrade.cpu_refused']}")

        # 5. B and C clean: 4s's references
        frames = [want_a]
        for i, tag in ((1, "b"), (2, "c")):
            status, body, client = post(payloads[i], f"clean-{tag}")
            if status != 200:
                fail(f"4r: table {tag} answered {status}: {body}")
            frames.append(json.dumps(body["frame"]))
            res[f"clean_{tag}_wall_s"] = client["round_trip_s"]

        # 6. the endpoints, then the drain
        status, health, _ = http(srv.port, "/healthz")
        status_m, metrics, _ = http(srv.port, "/metrics")
        names = ("delphi_serve_requests", "delphi_serve_accepted",
                 "delphi_serve_completed", "delphi_serve_failed",
                 "delphi_serve_table_cache_hits",
                 "delphi_serve_table_cache_misses",
                 "delphi_serve_queue_depth", "delphi_serve_in_flight",
                 "delphi_resilience_degrade_cpu_refused")
        missing = [n for n in names if f"\n{n} " not in metrics]
        if status != 200 or health.get("status") != "ok" \
                or status_m != 200 or missing:
            fail(f"4r: /healthz {status} {health}, /metrics {status_m} "
                 f"lacks {missing}")
        srv.drain(grace_s=30)
        if not srv.wait(timeout=60):
            fail("4r: the server did not stop after its drain")
        final = srv.recorder.registry.snapshot()["counters"] \
            if srv.recorder is not None else {}
        if any(s is None for _, s in answered):
            fail(f"4r: a request was not answered: {answered}")
        res["health"] = health
        res["answered"] = answered
        res["serve_counters"] = {k: v for k, v in final.items()
                                 if k.startswith("serve.")}
        log(f"[served] /healthz {json.dumps(health)}; drained with every "
            f"admitted request answered: {answered}")
    finally:
        srv.stop()
        if saved_cc is None:
            os.environ.pop("DELPHI_COMPILE_CACHE_DIR", None)
        else:
            os.environ["DELPHI_COMPILE_CACHE_DIR"] = saved_cc
        shutil.rmtree(cache, ignore_errors=True)
    return {"summary": res, "payloads": payloads, "frames": frames,
            "fingerprints": fps}


def worker_gauges(port: int) -> dict:
    """A fleet worker's device and process gauges from its ``/metrics``
    (its live plane's resource sampler: the caching allocator's bytes on
    the card, not the CUDA context)."""
    text = http(port, "/metrics")[1]
    want = ("delphi_device_bytes_in_use", "delphi_device_peak_bytes_in_use",
            "delphi_process_rss_gb", "delphi_compile_cache_hits",
            "delphi_compile_cache_requests")
    return {line.split()[0]: float(line.split()[1])
            for line in text.splitlines() if line.split()[:1]
            and line.split()[0] in want}


def fleet_plane(torch, T, build, served) -> dict:
    """Phase 4s (module docstring). Returns the phase's summary."""
    import shutil
    import tempfile
    from delphi_tpu_torch.observability.fleet import (
        AutoscalePolicy, FleetAutoscaler, FleetRouter, rendezvous_rank,
    )
    payloads, frames = served["payloads"], served["frames"]
    homes = [rendezvous_rank(fp, ["0", "1"])[0]
             for fp in served["fingerprints"]]
    # the table the kill rides: one whose home is worker 1 where there is
    # one, so that "1:<site>:1:rank_death" fires there on first contact
    y = homes.index("1") if "1" in homes else 0
    victim = homes[y]
    x, z = [i for i in range(3) if i != y]
    index = {"x": x, "y": y, "z": z}
    plan = f"{victim}:{FLEET_KILL_SITE}:1:rank_death"
    cache = tempfile.mkdtemp(prefix="smoke_fleet_")
    free0, _ = torch.cuda.mem_get_info()
    # the workers load phase 2's library from its build directory; their
    # live planes sample the card's allocator (no HTTP server of its own)
    router = FleetRouter(port=0, workers=2, cache_dir=cache, heartbeat_s=0.5,
                         worker_env={"DELPHI_FLEET_HEARTBEAT_S": "0.5",
                                     "DELPHI_COMPILE_CACHE_DIR":
                                         build.BUILD_DIR,
                                     "DELPHI_STALL_TIMEOUT_S": "600",
                                     "DELPHI_RESOURCE_SAMPLE_S": "0.5"})
    scaler = None
    res = {"homes": homes, "victim": victim, "plan": plan}
    try:
        t0 = time.perf_counter()
        router.start()
        res["start_s"] = time.perf_counter() - t0
        res["spawn_to_registration_s"] = dict(router.spawn_seconds)
        log(f"[fleet] two workers registered: spawn to registration "
            f"{json.dumps(router.spawn_seconds)} s, router up in "
            f"{res['start_s']:.3f} s")
        scaler = FleetAutoscaler(
            router, AutoscalePolicy(min_workers=2, max_workers=3),
            interval_s=0.5).start()
        walls, results = {}, {}

        def send(n, tag, **extra):
            ti = index[tag]
            t = time.perf_counter()
            results[n] = (ti, *http(router.port, "/repair",
                                    dict(payloads[ti], request_id=f"f{n}",
                                         **extra))[:2])
            walls[n] = time.perf_counter() - t

        send(0, FLEET_ORDER[0])
        send(1, FLEET_ORDER[1])
        time.sleep(1.0)  # two sampler ticks
        gauges_pre = {w: worker_gauges(router._workers[w]["port"])
                      for w in ("0", "1")}
        free_pre, _ = torch.cuda.mem_get_info()
        threads = [threading.Thread(target=send, args=(2, FLEET_ORDER[2]),
                                    kwargs={"fault_plan": plan}),
                   threading.Thread(target=send, args=(3, FLEET_ORDER[3]))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
        send(4, FLEET_ORDER[4])
        send(5, FLEET_ORDER[5])
        for n in range(len(FLEET_ORDER)):
            ti, status, body = results.get(n, (None, None, {}))
            if status != 200 or json.dumps(body.get("frame")) != frames[ti]:
                fail(f"4s: request {n} (table {ti}) answered {status} or "
                     f"another frame than 4r's: {str(body)[:300]}")
        code = router._procs[victim].wait(timeout=120)
        if code != 17:
            fail(f"4s: worker {victim} exited {code}, not 17 (rank_death)")
        snap = router.recorder.registry.snapshot()["counters"]
        if snap.get("fleet.evictions", 0) < 1 \
                or snap.get("fleet.redispatches", 0) < 1:
            fail(f"4s: no eviction or redispatch counted: {snap}")
        status, health, _ = http(router.port, "/healthz")
        if health.get("status") != "degraded":
            fail(f"4s: /healthz reads {health}")
        survivor = "1" if victim == "0" else "0"
        time.sleep(1.0)
        gauges_post = worker_gauges(router._workers[survivor]["port"])
        res.update({
            "request_walls_s": [walls[n] for n in range(len(FLEET_ORDER))],
            "tables": [results[n][0] for n in range(len(FLEET_ORDER))],
            "hops": [results[n][2].get("hops")
                     for n in range(len(FLEET_ORDER))],
            "workers": [results[n][2].get("worker_id")
                        for n in range(len(FLEET_ORDER))],
            "victim_exit": code,
            "fleet_counters": {k: v for k, v in snap.items()
                               if k.startswith(("fleet.", "autoscale."))},
            "health": health,
            "worker_gauges_before_kill": gauges_pre,
            "survivor_gauges_after": gauges_post,
            "card_mib_all_workers_before_kill":
                round((free0 - free_pre) / 2**20, 1),
            "autoscale_events": list(scaler.events)})
        log(f"[fleet] six requests over three tables, worker {victim} "
            f"killed by {plan} mid-traffic: every frame equals 4r's; "
            f"{json.dumps(res, default=str)}")
    finally:
        if scaler is not None:
            scaler.stop()
        router.drain()
        for wid, proc in router._procs.items():
            if proc.poll() is None:
                proc.kill()
            proc.wait(timeout=60)
        if any(p.returncode is None for p in router._procs.values()):
            fail("4s: a worker process outlived the phase")
        shutil.rmtree(cache, ignore_errors=True)
    return res


# -- 4t: the gauntlet on the card --------------------------------------------

GAUNTLET_ROWS = 2_000      # 4t(a): the CLI's default
GAUNTLET_FAIL_OVER = 0.25


def sklearn_present() -> bool:
    """Whether scikit-learn imports here: the gauntlet's downstream triple
    fits its decision trees (``gauntlet/score.py``), and the card's
    machine may lack it."""
    try:
        import sklearn  # noqa: F401
    except ImportError:
        return False
    return True


def null_downstream(data, repaired, seed=0) -> dict:
    """``runner.downstream_score``'s stand-in where scikit-learn does not
    import: the triple's keys with every score null (the drift gate reads
    cell F1 and the scorecards, not the triple)."""
    return {"task": data.task,
            "metric": "r2" if data.task == "regression" else "accuracy",
            "dirty": None, "repaired": None, "clean": None,
            "gap_closed": None, "train_rows": None, "test_rows": None}


class downstream_or_null:
    """Runs the gauntlet's own runner unchanged where scikit-learn imports;
    elsewhere only ``runner.downstream_score`` becomes
    :func:`null_downstream` inside the block. ``with`` gives whether the
    real triple is computed."""

    def __enter__(self) -> bool:
        from delphi_tpu_torch.gauntlet import runner
        self._saved = None
        if sklearn_present():
            return True
        self._saved = runner.downstream_score
        runner.downstream_score = null_downstream
        return False

    def __exit__(self, *exc) -> None:
        from delphi_tpu_torch.gauntlet import runner
        if self._saved is not None:
            runner.downstream_score = self._saved


def gauntlet_checks(healthy: dict, baseline: dict, gate_degraded: dict,
                    downstream: bool) -> dict:
    """The checks of the JAX package's ``bench.gauntlet_smoke``: every
    scenario scored, mean cell F1 above 0, some recall above 0.5, the
    per-scenario gate passing ``healthy`` against ``baseline``, and the
    gate's verdict on the run without repairs (``gate_degraded``) a trip.
    Without ``downstream`` the triple is not asked for."""
    from delphi_tpu_torch.observability import drift
    gate_self = drift.evaluate_gauntlet(healthy, baseline,
                                        fail_over=GAUNTLET_FAIL_OVER)
    scenarios = healthy["scenarios"].values()
    f1s = [s["repair"]["f1"] for s in scenarios]

    def scored(s):
        return not s.get("error") \
            and {"f1", "precision", "recall"} <= set(s["repair"]) \
            and (not downstream or all(
                s["downstream"].get(k) is not None
                for k in ("dirty", "repaired", "clean")))

    return {
        "all_scored": len(f1s) == 5 and all(scored(s) for s in scenarios),
        "mean_f1_positive": sum(f1s) / max(1, len(f1s)) > 0,
        "some_recall": any(s["repair"]["recall"] > 0.5 for s in scenarios),
        "self_gate_passes": gate_self["failed"] is False
                            and gate_self["baseline_missing"] is False,
        "degraded_gate_trips": gate_degraded["failed"] is True,
    }


def gauntlet_cli(args: list, timeout: int = 900):
    """``python -m delphi_tpu_torch.main --gauntlet ARGS`` in a subprocess:
    (exit code, stdout, stderr, wall s)."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "delphi_tpu_torch.main", "--gauntlet", *args],
        cwd=HERE, capture_output=True, text=True, timeout=timeout)
    return (proc.returncode, proc.stdout, proc.stderr,
            time.perf_counter() - t0)


def gauntlet_plane(torch, T, traced, path_launches) -> dict:
    """Phase 4t (module docstring). Returns the phase's summary."""
    import shutil
    import tempfile
    from delphi_tpu_torch.gauntlet import SCENARIOS, generate_scenario
    from delphi_tpu_torch.gauntlet import runner
    from delphi_tpu_torch.observability import drift, load_run_report
    from delphi_tpu_torch.ops.kernels import domain_scores as k_domain
    from delphi_tpu_torch.ops.kernels import entropy as k_entropy
    from delphi_tpu_torch.ops.kernels import pair_counts as k_pair
    from delphi_tpu_torch.utils import phase_walls
    names = sorted(SCENARIOS)
    downstream = sklearn_present()
    res = {"sklearn": downstream}
    tmp = tempfile.mkdtemp(prefix="smoke_gauntlet_")
    try:
        # (a) all five at the CLI's default 2,000 rows, then the gate
        t0 = time.perf_counter()
        if downstream:
            r1 = os.path.join(tmp, "r1.json")
            rc, out, err, wall = gauntlet_cli(
                ["--gauntlet-rows", str(GAUNTLET_ROWS), "--metrics-out", r1])
            lines = [ln for ln in err.splitlines()
                     if ln.startswith("gauntlet ") and ": f1=" in ln]
            if rc != 0 or len(lines) != len(names):
                fail(f"4t(a): --gauntlet exited {rc} with {len(lines)} "
                     f"scenario lines: {err[-2000:]}")
            report = load_run_report(r1)
            healthy = report["gauntlet"]
            rc3, out3, err3, wall3 = gauntlet_cli(
                ["--gauntlet-rows", str(GAUNTLET_ROWS),
                 "--gauntlet-no-repairs", "--baseline-report", r1,
                 "--drift-fail-over", str(GAUNTLET_FAIL_OVER)])
            if rc3 != 3:
                fail(f"4t(a): the degraded run exited {rc3}, not 3: "
                     f"{err3[-2000:]}")
            gate = json.loads(out3.strip().splitlines()[-1])["drift"]
            checks = gauntlet_checks(healthy, report, gate, downstream)
            res["a"] = {"cli_wall_s": wall, "degraded_cli_wall_s": wall3,
                        "stdout": json.loads(out.strip().splitlines()[-1]),
                        "lines": lines}
        else:
            # the runner in this process with a null downstream triple; the
            # CLI fits the downstream trees, so it must fail loudly here
            with downstream_or_null():
                healthy = runner.run_gauntlet(names=names,
                                              rows=GAUNTLET_ROWS, seed=0)
                degraded = runner.run_gauntlet(names=names,
                                               rows=GAUNTLET_ROWS, seed=0,
                                               repairs_enabled=False)
            gate = drift.evaluate_gauntlet(degraded, {"gauntlet": healthy},
                                           fail_over=GAUNTLET_FAIL_OVER)
            checks = gauntlet_checks(healthy, {"gauntlet": healthy}, gate,
                                     downstream)
            rc, _, err, wall = gauntlet_cli(
                ["--gauntlet-no-repairs", "--gauntlet-rows", "160",
                 "--gauntlet-scenarios", "fd_categorical"])
            if rc == 0 or "sklearn" not in err:
                fail(f"4t(a): without scikit-learn --gauntlet exited {rc}; "
                     f"it must fail naming sklearn: {err[-2000:]}")
            res["a"] = {"cli_without_sklearn": {
                "exit": rc, "wall_s": wall,
                "error": err.strip().splitlines()[-1]}}
        res["a"]["wall_s"] = time.perf_counter() - t0
        res["a"]["checks"] = checks
        res["a"]["degraded_severity"] = gate["max_severity"]
        res["a"]["scenarios"] = {
            n: {k: s["repair"][k] for k in ("f1", "precision", "recall")}
            for n, s in healthy["scenarios"].items()}
        if not all(checks.values()):
            fail(f"4t(a): gauntlet checks failed: {checks}")
        log(f"[gauntlet] (a) five scenarios at {GAUNTLET_ROWS} rows "
            f"({'the CLI' if downstream else 'the runner in process'})"
            f", the gate passing itself and tripping without repairs: "
            f"{json.dumps(res['a'], default=str)}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # (b) each scenario at the top of its scale series, as one main path
    tables = {n: generate_scenario(n, max(SCENARIOS[n].scales), 0)
              for n in names}
    per = {}

    def run_all():
        for name in names:
            data = tables[name]
            before = (k_pair.launches, k_entropy.launches,
                      k_domain.mode_launches["int"])
            walls0 = dict(phase_walls)
            t = time.perf_counter()
            with downstream_or_null():
                entry = runner.run_scenario(data, seed=0)
            if entry.get("error"):
                fail(f"4t(b) {name}: {entry['error']}")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            per[name] = {
                "rows": len(data.clean), "wall_s": wall,
                "phase_walls_s": {k: round(v - walls0.get(k, 0.0), 3)
                                  for k, v in phase_walls.items()
                                  if v != walls0.get(k, 0.0)},
                **{k: entry["repair"][k] for k in
                   ("injected", "repairs", "correct", "f1", "precision",
                    "recall")},
                "gap_closed": (entry.get("downstream") or {}).get(
                    "gap_closed"),
                "launches": {
                    "pair_counts": k_pair.launches - before[0],
                    "entropy_terms": k_entropy.launches - before[1],
                    "domain_scores_int":
                        k_domain.mode_launches["int"] - before[2]}}
            if entry["repair"]["repairs"] < 1:
                fail(f"4t(b) {name}: no repair at {len(data.clean)} rows")
            log(f"[gauntlet] (b) {name}: {json.dumps(per[name])}")

    _, wall, launches, _, _, peak, _ = traced("gauntlet", run_all)
    res["b"] = {"wall_s": wall, "peak_mib": peak, "scenarios": per}
    total = path_launches["gauntlet"]
    for name in ("pair_counts", "entropy_terms", "k5_int"):
        if total.get(name, 0) < 1:
            fail(f"4t: {name} was not launched by the gauntlet's runs")
    log(f"[gauntlet] (b) the five scenarios at the top of their series in "
        f"{wall:.3f} s, launches {json.dumps(total)}, peak device memory "
        f"{peak:.1f} MiB")
    return res


# -- 4u: sustained open-loop load against port workers -----------------------

# the shape of the JAX package's load smoke (bench.load_smoke): one
# scenario family, so one table shape, over 8 fingerprints
LOAD_SHAPE = {
    "requests": 60, "fingerprints": 8, "rows": 24, "rate_rps": 6.0,
    "spike_x": 5.0, "zipf_alpha": 1.1,
    "mix": {"batch": 0.7, "incremental": 0.15, "stream": 0.15},
    "retry_max": 2, "workers": 2, "seed": 17,
    "autoscale": {"min_workers": 2, "max_workers": 3, "up_queue_depth": 2,
                  "down_queue_depth": 0, "sustain_ticks": 2,
                  "cooldown_s": 3600.0},
    "autoscale_interval_s": 0.25, "kill_original_worker": True,
    "scenarios": ["fd_categorical"],
    # cold workers' latencies wobble: the recovery verdict is informational
    "recovery_fail_over": 50.0}
# one repair thread and a short queue per worker, so that queue pressure
# (the autoscaler's signal) builds at the smoke's rates
LOAD_WORKER_ENV = {"DELPHI_FLEET_HEARTBEAT_S": "0.5",
                   "DELPHI_SERVE_WORKERS": "1",
                   "DELPHI_SERVE_QUEUE_DEPTH": "8",
                   "DELPHI_SERVE_RETRY_AFTER_S": "1"}


def load_run(*, requests, fingerprints, rows, rate_rps, spike_x,
             zipf_alpha, mix, retry_max, workers, seed, autoscale=None,
             autoscale_interval_s=0.25, kill_original_worker=True,
             recovery_fail_over=0.5, scenarios=None, worker_env=None,
             label="load"):
    """One open-loop load run (``delphi_tpu_torch.observability.load``)
    against ``workers`` spawned port workers behind a ``FleetRouter``,
    with a ``FleetAutoscaler`` when ``autoscale`` holds its policy, one
    original worker hard-killed at the ``post_kill`` boundary, the way
    the JAX package's ``bench._run_load`` drives its fleet. The recorder
    opens first, so the router, the autoscaler and the load's counters
    share one registry. Returns ``(slo section, run info, registry
    snapshot)``; every process it started has ended."""
    import shutil
    import tempfile
    import urllib.error
    import urllib.request
    from delphi_tpu_torch import observability as obs
    from delphi_tpu_torch.observability import load as loadgen
    from delphi_tpu_torch.observability.fleet import (AutoscalePolicy,
                                                      FleetAutoscaler,
                                                      FleetRouter)
    saved = os.environ.get("DELPHI_RETRY_BASE_S")
    os.environ["DELPHI_RETRY_BASE_S"] = "0.001"
    cache = tempfile.mkdtemp(prefix=f"smoke_{label}_")
    tables = loadgen.make_tables(fingerprints, rows, seed,
                                 scenarios=scenarios)
    segments = loadgen.default_segments(requests, rate_rps, spike_x)
    schedule = loadgen.build_schedule(segments, fingerprints, zipf_alpha,
                                      mix, seed)
    rec = obs.start_recording(f"smoke.{label}")
    router = FleetRouter(port=0, workers=workers, cache_dir=cache,
                         heartbeat_s=0.5, worker_env=worker_env)
    scaler = None
    kill = {"worker": None, "at_segment": None}
    segment_counters, prev, current = {}, [{}], [None]

    def post(body, timeout=180):
        req = urllib.request.Request(
            f"http://127.0.0.1:{router.port}/repair",
            data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"}, method="POST")
        try:
            with urllib.request.urlopen(req, timeout=timeout) as r:
                return r.status, json.loads(r.read()), dict(r.headers)
        except urllib.error.HTTPError as e:
            try:
                return e.code, json.loads(e.read() or b"{}"), \
                    dict(e.headers or {})
            except ValueError:
                return e.code, {}, dict(e.headers or {})
        except Exception:
            return None, {}, {}

    def close_segment(next_name):
        now = dict(rec.registry.snapshot()["counters"])
        if current[0] is not None:
            segment_counters[current[0]] = {
                k: v - prev[0].get(k, 0) for k, v in now.items()
                if v != prev[0].get(k, 0)}
        prev[0], current[0] = now, next_name

    def on_segment(name):
        close_segment(name)
        if name == "post_kill" and kill_original_worker:
            live = router.refresh_membership()
            originals = [w for w in ("0", "1") if w in live]
            if originals:
                victim = originals[-1]
                proc = router._procs.get(victim)
                if proc is not None and proc.poll() is None:
                    proc.kill()
                    kill.update(worker=victim, at_segment=name)

    try:
        t0 = time.perf_counter()
        router.start()
        start_s = time.perf_counter() - t0
        if autoscale:
            scaler = FleetAutoscaler(
                router, policy=AutoscalePolicy(**autoscale),
                interval_s=autoscale_interval_s).start()
        runner = loadgen.OpenLoopRunner(schedule, tables, post,
                                        retry_max=retry_max,
                                        on_segment=on_segment)
        records = runner.run()
        if scaler is not None:
            scaler.stop()
        close_segment(None)
        slo = loadgen.slo_section(
            records, segments, runner.duration_s,
            segment_counters=segment_counters,
            autoscale_events=scaler.events if scaler else [],
            kill=kill if kill["worker"] else None,
            recovery_fail_over=recovery_fail_over)
        rec.slo = slo
        info = {"arrivals": len(schedule), "fingerprints": fingerprints,
                "workers_started": workers,
                "workers_final": router.refresh_membership(),
                "spawn_to_registration_s": dict(router.spawn_seconds),
                "router_start_s": start_s}
        return slo, info, rec.registry.snapshot()
    finally:
        if scaler is not None:
            scaler.stop()
        router.drain()
        for proc in router._procs.values():
            if proc.poll() is None:
                proc.kill()
            proc.wait(timeout=60)
        obs.stop_recording(rec)
        shutil.rmtree(cache, ignore_errors=True)
        if saved is None:
            os.environ.pop("DELPHI_RETRY_BASE_S", None)
        else:
            os.environ["DELPHI_RETRY_BASE_S"] = saved


def load_checks(slo: dict, info: dict, snapshot: dict) -> dict:
    """The ten checks of the JAX package's ``bench.load_smoke``, with the
    drift gate run both ways: the run against itself passes, and against
    a baseline claimed three times faster at three times the throughput
    with nothing shed it trips."""
    from delphi_tpu_torch.observability import drift
    counters = snapshot["counters"]
    acct = slo["requests"]
    p99 = slo["latency"]["p99"] or 0.1
    degraded_baseline = {"slo": {
        "requests": dict(acct), "qps": (slo["qps"] or 1.0) * 3.0,
        "shed_rate": 0.0, "latency": dict(slo["latency"], p99=p99 / 3.0),
        "per_segment": {}}}
    gate_self = drift.evaluate_slo(slo, {"slo": slo}, fail_over=0.2)
    gate_degraded = drift.evaluate_slo(slo, degraded_baseline,
                                       fail_over=0.2)
    return {
        "slo_present": bool(slo and slo.get("requests")),
        "accounting_consistent": bool(slo.get("consistent"))
            and acct["sent"] == info["arrivals"]
            == acct["answered"] + acct["shed"] + acct["gave_up"],
        "all_segments_bucketed": all(
            name in slo["per_segment"]
            for name in ("warmup", "steady", "spike", "post_kill")),
        "fingerprints_mixed": slo["distinct_fingerprints"] >= 4
            and set(slo["mix"]) == {"batch", "incremental", "stream"},
        "latency_measured": (slo["latency"]["count"] or 0) > 0
            and slo["latency"]["p99"] is not None,
        "worker_attribution": any(slo["per_worker"]),
        "autoscale_fired_exactly_once":
            counters.get("autoscale.up", 0) == 1
            and counters.get("autoscale.down", 0) == 0,
        "worker_killed": bool(slo.get("kill"))
            and slo["kill"]["at_segment"] == "post_kill",
        "self_baseline_passes": not gate_self["failed"],
        "degraded_baseline_trips": bool(gate_degraded["failed"]),
    }


def load_plane(build) -> dict:
    """Phase 4u (module docstring). Returns the phase's summary."""
    t0 = time.perf_counter()
    slo, info, snapshot = load_run(
        **LOAD_SHAPE, label="load",
        worker_env={**LOAD_WORKER_ENV,
                    "DELPHI_COMPILE_CACHE_DIR": build.BUILD_DIR})
    checks = load_checks(slo, info, snapshot)
    res = {"wall_s": time.perf_counter() - t0, "checks": checks,
           "requests": slo["requests"], "qps": slo["qps"],
           "answered_qps": slo["answered_qps"],
           "p50_s": slo["latency"]["p50"], "p99_s": slo["latency"]["p99"],
           "shed_rate": slo["shed_rate"],
           "warm_hit_ratio": slo["warm_hit_ratio"],
           "autoscale_events": slo["autoscale"]["events"],
           "kill": slo["kill"], "recovery": slo["recovery"],
           "per_segment": {n: {k: s[k] for k in ("sent", "answered", "shed",
                                                 "qps", "latency")}
                           for n, s in slo["per_segment"].items()},
           **info}
    log(f"[load] {json.dumps(res, default=str)}")
    if not all(checks.values()):
        fail(f"4u: load checks failed: {checks}")
    return res


# -- 4n: the run report on the card -----------------------------------------

# the phases of the JAX package's report of this run, in order (the port's
# report may hold more spans, e.g. a worker thread's, beside them)
REPORT_PHASES = ["input validation", "error detection", "attr stats",
                 "cell domain analysis", "repair model training",
                 "repairing"]
# the hand kernels' names in the profile, by the phase that launches them
REPORT_KERNELS = {"attr stats": ["pair_counts_kernel",
                                 "entropy_terms_kernel"],
                  "cell domain analysis": ["domain_kernel"]}


def check_device_time(tag, dt, events) -> dict:
    """Fails unless a profiled 1M run's report section ``dt`` is complete
    (its profile's primer kept a record), credits device time to attr
    stats and domain, and its records (``events``) hold each hand kernel
    inside the phase that launches it; returns each hand kernel's device
    s there."""
    from delphi_tpu_torch.utils import profiling
    if dt is None:
        fail(f"{tag}: the profiled run's report has no device_time")
    if not dt["complete"]:
        fail(f"{tag}: {profiling.INCOMPLETE} (its primer of "
             f"{profiling.PRIMER_LAUNCHES} launches kept no record)")
    for phase in ("attr stats", "cell domain analysis"):
        if not dt["per_phase"].get(phase, 0) > 0:
            fail(f"{tag}: no device time credited to {phase!r}: "
                 f"{dt['per_phase']}")
    # every kernel's device time inside each phase, from the run's own
    # records (the report lists the top few)
    windows = profiling.annotation_windows(events, REPORT_PHASES)
    per_kernel = profiling.phase_kernels(events, windows, 1 << 30)
    hand = {}
    for phase, kernels in REPORT_KERNELS.items():
        for k in kernels:
            got = sum(t for n, t in per_kernel.get(phase, []) if k in n)
            if got <= 0:
                fail(f"{tag}: kernel {k} has no device time in {phase!r}")
            hand[k] = got
    return hand


def late_profile_check(torch, T, dirty, out) -> dict:
    """Phase 4n, late (module docstring): 4's table once more with the
    report and a device profile, at the end of this long process, held to
    4n's checks."""
    import shutil
    import tempfile
    from delphi_tpu_torch import observability as obs
    work = tempfile.mkdtemp(prefix="delphi_report_late_")
    keep = []
    orig_build = obs.build_run_report

    def kept_build(recorder, **kw):
        keep.append(recorder)
        return orig_build(recorder, **kw)

    env = {"DELPHI_METRICS_PATH": os.path.join(work, "late.json"),
           "DELPHI_PROFILE_DIR": os.path.join(work, "prof")}
    prior = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    obs.build_run_report = kept_build
    try:
        frame, wall, *_ = timed_run(torch, lambda: repair(T, dirty))
        if not frame.equals(out):
            fail("4n (late): the profiled frame differs from 4's")
        report = obs.load_run_report(env["DELPHI_METRICS_PATH"])
        dt = report["device_time"]
        hand = check_device_time("4n (late)", dt, keep[-1].device_events)
        res = {"wall_s": wall, "per_phase_device_s": dt["per_phase"],
               "hand_kernel_device_s": hand, "complete": dt["complete"],
               "device_busy_s": dt["device_busy_s"]}
        log(f"[report] late profiled 1M run: {json.dumps(res)}")
        return res
    finally:
        obs.build_run_report = orig_build
        for k, v in prior.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(work, ignore_errors=True)


def run_report_plane(torch, T, traced, dirty, out, e2e_wall) -> dict:
    """Phase 4n (module docstring): 4's table at 4's options with the
    report, with the report and a device profile (the main path, traced
    as "report"), and with DELPHI_PLAN_COST=1; 4's run (``e2e_wall``) is
    the wall without the report."""
    import shutil
    import tempfile
    from delphi_tpu_torch import observability as obs
    from delphi_tpu_torch.utils import profiling
    work = tempfile.mkdtemp(prefix="delphi_report_")
    keep = []
    orig_build = obs.build_run_report

    def kept_build(recorder, **kw):
        keep.append(recorder)
        return orig_build(recorder, **kw)

    def with_env(env, fn):
        prior = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        try:
            return fn()
        finally:
            for k, v in prior.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v

    res = {}
    try:
        rep_path = os.path.join(work, "report.json")
        only, wall_report, *_ = timed_run(torch, lambda: with_env(
            {"DELPHI_METRICS_PATH": rep_path}, lambda: repair(T, dirty)))
        prof_dir = os.path.join(work, "prof")
        prof_path = os.path.join(work, "profiled.json")
        obs.build_run_report = kept_build
        try:
            profiled, wall_prof, launches, counts, walls, _, _ = traced(
                "report", lambda: with_env(
                    {"DELPHI_METRICS_PATH": prof_path,
                     "DELPHI_PROFILE_DIR": prof_dir},
                    lambda: repair(T, dirty)))
        finally:
            obs.build_run_report = orig_build
        cost, wall_cost, *_ = timed_run(torch, lambda: with_env(
            {"DELPHI_PLAN_COST": "1"}, lambda: repair(T, dirty)))
        for label, frame in (("with the report", only),
                             ("with the report and profile", profiled),
                             ("with DELPHI_PLAN_COST=1", cost)):
            if not frame.equals(out):
                fail(f"4n: the frame {label} differs from 4's")
        for name, count in launches.items():
            if count < 1:
                fail(f"4n: the reported run did not launch {name}")
        report = obs.load_run_report(prof_path)
        if report is None or report["status"] != "ok":
            fail(f"4n: the profiled run's report did not load as ok: "
                 f"{None if report is None else report.get('status')}")
        if obs.load_run_report(rep_path) is None:
            fail("4n: the report-only run wrote no loadable report")
        names = [c["name"] for c in report["spans"]["children"]]
        if [n for n in names if n in REPORT_PHASES] != REPORT_PHASES:
            fail(f"4n: the report's phases {names} lack the JAX package's "
                 f"{REPORT_PHASES}")
        events = keep[-1].device_events
        dt = report["device_time"]
        hand = check_device_time("4n", dt, events)
        busy = dt["device_busy_s"]
        root_wall = report["spans"]["wall_s"]
        # the root span also holds the profile's stop and export; the
        # phases' own walls do not
        phases_wall = sum(c["wall_s"] for c in report["spans"]["children"]
                          if c["name"] in REPORT_PHASES)
        launch_costs = report.get("launch_costs") or {}
        res = {
            "wall_s": {"without_report_phase_4": e2e_wall,
                       "with_report": wall_report,
                       "with_report_and_profile": wall_prof,
                       "with_plan_cost": wall_cost},
            "device_busy_s": busy, "root_span_wall_s": root_wall,
            "device_idle_share": 1.0 - busy / root_wall,
            "phases_wall_s": phases_wall,
            "device_idle_share_in_phases": 1.0 - busy / phases_wall,
            "per_phase_device_s": dt["per_phase"],
            "hand_kernel_device_s": hand,
            "per_phase_kernels": dt["per_phase_kernels"],
            "top_kernels": dt["top_kernels"],
            "report_bytes": os.path.getsize(prof_path),
            "report_only_bytes": os.path.getsize(rep_path),
            "trace_bytes": dir_bytes(prof_dir),
            "device_events": len(events),
            "ledger_buckets": launch_costs.get("buckets"),
            "ledger_device_s": launch_costs.get("device_s"),
            "phase_walls_profiled": walls,
        }
        log(f"[report] 1M run walls: without the report (4's run) "
            f"{e2e_wall:.3f} s, with the report {wall_report:.3f} s, "
            f"with the report and profile {wall_prof:.3f} s, with "
            f"DELPHI_PLAN_COST=1 {wall_cost:.3f} s; all three frames equal "
            "4's")
        log(f"[report] device busy {busy:.6f} s of the root span's "
            f"{root_wall:.3f} s: idle share {res['device_idle_share']:.6f} "
            f"({res['device_idle_share_in_phases']:.6f} of the phases' "
            f"{phases_wall:.3f} s)")
        log(f"[report] per-phase device s: {json.dumps(dt['per_phase'])}")
        log(f"[report] hand kernels' device s in their phases: "
            f"{json.dumps(hand)}")
        log(f"[report] per-phase top kernels: "
            f"{json.dumps(dt['per_phase_kernels'])}")
        log(f"[report] report {res['report_bytes']} bytes (report only "
            f"{res['report_only_bytes']}), trace {res['trace_bytes']} bytes, "
            f"{len(events)} device and range records; launch-cost ledger "
            f"{res['ledger_buckets']} buckets, "
            f"{res['ledger_device_s']} device s")
        return res
    finally:
        shutil.rmtree(work, ignore_errors=True)


def repair_accuracy(clean, out) -> float:
    """Share of repaired cells equal to the clean value (tid = row)."""
    if not len(out):
        return 0.0
    tids = out["tid"].to_numpy().astype(np.int64)
    attrs = out["attribute"].to_numpy(dtype=object)
    repaired = out["repaired"].to_numpy(dtype=object)
    hits = 0
    for a in np.unique(attrs):
        sel = attrs == a
        truth = clean[a].to_numpy(dtype=object)[tids[sel]]
        hits += int((repaired[sel] == truth).sum())
    return hits / len(out)


def repair(T, df, batched: bool = False, options=None):
    m = T.delphi.repair.setInput(df).setRowId("tid") \
        .setErrorDetectors([T.NullErrorDetector()]) \
        .setParallelStatTrainingEnabled(batched)
    for k, v in {**RUN_OPTIONS, **(options or {})}.items():
        m = m.option(k, v)
    return m.run()


def training_summary(reports) -> dict:
    """Per target: model, chosen config, CV score, CV-proven rounds, CV
    chunk steps; and the training wall split into CV search and final fit.
    The targets of one batched search or fit carry the same measured
    float, so summing the distinct values counts it once."""
    per_target = {}
    for r in reports:
        per_target[r["target"]] = {
            "model": type(r["model"]).__name__, "config": r.get("config"),
            "cv_score": r.get("cv_score"), "cv_rounds": r.get("cv_rounds"),
            "cv_chunks": r.get("cv_chunks"), "steps": r.get("steps")}
    return {"targets": per_target,
            "cv_search_s": sum({r.get("cv_seconds", 0.0) for r in reports}),
            "final_fit_s": sum({r.get("fit_seconds", 0.0) for r in reports})}


def logistic_gaps(T):
    """Wraps LogisticRegressionModel.predict to record each repair's
    top-two probability gap; returns (gaps list, restore function)."""
    from delphi_tpu_torch.models.linear import LogisticRegressionModel
    gaps, orig = [], LogisticRegressionModel.predict

    def predict(self, X):
        p = np.sort(np.asarray(self.predict_proba(X)), axis=1)
        gaps.append(p[:, -1] - p[:, -2])
        return orig(self, X)

    LogisticRegressionModel.predict = predict

    def restore():
        LogisticRegressionModel.predict = orig
    return gaps, restore


def boost_round_profile(torch, gbdt, k_gbdt, depth: int):
    """One CV step's tree building at the 1M-row run's shapes (3 folds x 8
    class trees of one 6-class target, 10,000 rows, 4 features, 64 bins):
    CUDA-event ms per round over 4 rounds, the kernels the profiler saw
    per round (None when it kept no device record), and the K3 launches
    of one round."""
    from torch.profiler import ProfilerActivity, profile
    g = torch.Generator(device="cuda").manual_seed(0)
    M, k, n, d = 3, 8, 10_000, 4
    bins = torch.randint(0, 64, (M, n, d), device="cuda", generator=g)
    y = torch.randint(0, 6, (M, n), device="cuda", generator=g).float()
    w = torch.ones((M, n), device="cuda")
    F = torch.zeros((M, k, n), device="cuda")

    def run(rounds):
        return gbdt._boost(bins, y, w, F, rounds, depth, 64, "multiclass", k,
                           0.1, 1.0, 0.0, 1.0, 0.0, use_counts=False,
                           collect_trees=False)

    run(1)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    run(4)
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / 4
    k_gbdt.reset_launches()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run(1)
        torch.cuda.synchronize()
    hand = dict(k_gbdt.launches)
    kernels = sum(1 for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA)
    return ms, (kernels or None), hand


def time_ms(torch, fn, flush, reps: int = 15) -> float:
    """CUDA-event median of ``fn`` over ``reps`` launches, L2 flushed
    (a 256 MB write) before each, after one warm-up call."""
    fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)




def profiled_kernel_durations(torch, flush, reps: int = 15) -> list:
    """Per pending row, the device ns of each kernel record whose name
    contains one of the row's names, from ONE ``torch.profiler`` session
    over every row's ``reps`` calls (L2 flushed before each), joined launch
    by launch: each row's calls run inside a ``record_function`` range,
    and a kernel record belongs to the row whose range's device-side
    shadow holds it. The shadow is on the card's clock: late in a long
    process the host's range and the card's records drift apart by about
    a millisecond, enough to move launches between neighbouring rows
    (``delphi_tpu_torch.utils.profiling`` normalizes the records, as for
    the run report)."""
    import bisect
    from torch.profiler import ProfilerActivity, profile, record_function
    from delphi_tpu_torch.utils import profiling
    for _, _, fn, _, _, _ in PENDING_KERNEL_MS:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        # a later session can lose its first launches' records: the
        # port's primer takes that loss (utils/profiling.py)
        profiling.prime(torch)
        for i, (_, _, fn, _, _, _) in enumerate(PENDING_KERNEL_MS):
            with record_function(f"kernel_ms:{i}"):
                for _ in range(reps):
                    flush.zero_()
                    fn()
                # a PyTorch launch after the last call: the shadow spans
                # the work PyTorch's own launches bound, which then holds
                # every launch of the row
                flush.zero_()
                torch.cuda.synchronize()
    events = profiling.drop_primer(profiling.profiler_events(prof))
    if not events.complete:
        log(f"[timing] {profiling.INCOMPLETE}: the kernel_ms session's "
            "primer kept no record")
    windows = profiling.annotation_windows(
        events, [f"kernel_ms:{i}" for i in range(len(PENDING_KERNEL_MS))],
        kind=profiling.DEVICE_RANGE)
    spans = sorted((lo, hi, int(name.split(":")[1]))
                   for name, iv in windows.items() for lo, hi in iv)
    starts = [lo for lo, _, _ in spans]
    out = [[] for _ in PENDING_KERNEL_MS]
    for e in events:
        if e.kind != profiling.KERNEL:
            continue
        at = bisect.bisect_right(starts, e.start_ns) - 1
        if at < 0 or e.start_ns > spans[at][1]:
            continue
        i = spans[at][2]
        if any(n in e.name for n in PENDING_KERNEL_MS[i][4]):
            out[i].append(e.end_ns - e.start_ns)
    return out


def bare_ms(torch, launch, flush, reps: int = 15, burst: int = 20) -> float:
    """CUDA-event median over ``reps`` bursts of ``burst`` back-to-back bare
    ctypes launches (L2 flushed before each burst), per launch."""
    launch()
    times = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(burst):
            launch()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / burst)
    return statistics.median(times)


def host_ms(torch, fn, reps: int = 15) -> float:
    """Median host time of one call, enqueue only (the card idle before
    each)."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append(1e3 * (time.perf_counter() - t0))
    torch.cuda.synchronize()
    return statistics.median(times)


PROFILER_SEES_KERNELS = []
# (label, row, call, bare launch, kernel names, launches per call) whose
# kernel_ms the profiler fills in at the end of the run, so that no other
# timing and not the end-to-end run follow a profiling session; the launch
# floor is read again after it.
PENDING_KERNEL_MS = []


def defer_kernel_ms(label, row, fn, bare, names, per_call) -> None:
    row["kernel_ms"] = None
    PENDING_KERNEL_MS.append((label, row, fn, bare, names, per_call))


def finish_kernel_ms(torch, flush, reps: int = 15) -> int:
    """Fills every deferred row's ``kernel_ms``, the kernel's own device
    time per call: the profiler's when it kept one record per launch and
    its time is not below the row's bound, else the bare launches' (back
    to back, so L2 may hold their inputs). Returns how many rows still
    come from bare launches."""
    durations = profiled_kernel_durations(torch, flush, reps)
    for (label, row, fn, bare, names, per_call), d in zip(
            PENDING_KERNEL_MS, durations):
        ms = sum(d) / 1e6 / reps if d else None
        bound = row.get("bound_ms", 0.0)
        row["kernel_records"] = len(d)
        row["kernel_records_expected"] = reps * per_call
        ok = ms is not None and len(d) == reps * per_call and ms >= bound
        PROFILER_SEES_KERNELS.append(ok)
        if ok:
            row["kernel_ms"], row["kernel_ms_from"] = ms, "profiler"
        else:
            log(f"[timing] torch.profiler kept {len(d)} of "
                f"{reps * per_call} records of {names} (ms {ms}, bound "
                f"{bound}); kernel_ms from back-to-back bare ctypes "
                "launches")
            row["kernel_ms"] = bare_ms(torch, bare, flush)
            row["kernel_ms_from"] = "bare launches"
        log(f"[kernel-ms] {label}: kernel_ms={row['kernel_ms']} from "
            f"{row['kernel_ms_from']} ({row['kernel_records']} profiler "
            f"records of {row['kernel_records_expected']})")
    bare_rows = sum(1 for _, row, *_ in PENDING_KERNEL_MS
                    if row["kernel_ms_from"] != "profiler")
    log(f"[kernel-ms] {bare_rows} of {len(PENDING_KERNEL_MS)} kernel_ms "
        "rows from bare launches (the profiler's records missing or below "
        "the bound), the others from the profiler's records launch by "
        "launch")
    return bare_rows


def k1_bare(torch, k_pair, build, codes, pairs, vocab):
    """One call's K1 launches through ctypes alone (planned once)."""
    import ctypes
    out = torch.empty(int(k_pair.matrix_offsets(pairs, vocab)[-1]),
                      dtype=torch.int32, device=codes.device)
    plan = k_pair.plan_launches(tuple(map(tuple, pairs)), tuple(vocab))
    tables = k_pair.pack_tables(pairs, vocab, codes.data_ptr(),
                                out.data_ptr(), int(codes.shape[1]))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    lib, stream = build.library(), build.current_stream()
    args = [(ctypes.addressof(t),
             k_pair.grid_size(int(codes.shape[1]), sms, ln.smem_bytes),
             ln.smem_bytes, stream) for ln, t in zip(plan, tables)]

    def launch():
        for a in args:
            build.check(lib.delphi_pair_counts(*a), "pair_counts")
    launch.keep = (out, tables)
    return launch


def k2_bare(torch, k_entropy, build, counts, offsets, n_rows):
    """One call's K2 launch through ctypes alone (packed once)."""
    import ctypes
    t, outs = k_entropy.pack_table(counts, offsets, n_rows)
    lib, stream = build.library(), build.current_stream()

    def launch():
        build.check(lib.delphi_entropy_terms(ctypes.addressof(t), stream),
                    "entropy_terms")
    launch.keep = (t, outs)
    return launch


def k1_bound_ms(codes, pairs, vocab) -> float:
    """Each code column a pair reads, once, plus each output count written
    once, over the HBM rate."""
    cols = {c for p in pairs for c in p}
    n = int(codes.shape[1])
    out = sum((vocab[x] + 1) * (vocab[y] + 1) for x, y in pairs)
    return 1e3 * (4 * n * len(cols) + 4 * out) / HBM_BYTES_PER_S


def k2_bound_ms(counts, offsets):
    """(bytes ms, operations ms): counts and offsets read once, (h, total,
    nnz) written once per segment; f64 work on this data's nonzero counts.
    The bound is the larger of the two."""
    lo, hi = int(offsets[0]), int(offsets[-1])
    n_seg = len(offsets) - 1
    nnz = int((counts[lo:hi] > 0).sum().item())
    bytes_ms = 1e3 * (4 * (hi - lo) + 8 * (n_seg + 1) + 24 * n_seg) \
        / HBM_BYTES_PER_S
    return bytes_ms, 1e3 * K2_OPS_PER_NONZERO * nnz / FP64_OPS_PER_S


def k5_bound_ms(extents, weak: bool, active: int = 0):
    """(bytes ms, operations ms) of one K5 launch's real pieces, each given
    as (error cells m, values v_a, real rows of each correlate's pair
    table). Bytes: the m row indices and k * m gathered codes, the k pair
    tables at their real size, the k taus and column indices and the v_a
    flags (and, in the weak-label mode, the v_a vocab ranks) read once;
    written, 5 bytes a cell (weak-label mode: top and has_domain) or 9
    bytes a cell and value (integer mode: two int32 sums and a flag), over
    the HBM rate. Operations (weak-label mode): per cell and value the f64
    multiply and add of the numerator and the row sum's add, per
    ``active`` value (a correlate active: this data's count) the score's
    division, per cell the top probability's two divisions, over the FP64
    rate; the integer mode's compares are not counted. Padding of the
    launch (values up to the widest piece's, table rows up to vc_pad) is
    not counted."""
    total, values = 0, 0
    for m, v_a, vc in extents:
        k = len(vc)
        total += 4 * (m + k * m + sum(c * (v_a + 1) for c in vc) + 2 * k
                      + (2 if weak else 1) * v_a)
        total += 5 * m if weak else 9 * m * v_a
        values += m * v_a
    cells = sum(m for m, _, _ in extents)
    ops = 3 * values + active + 2 * cells if weak else 0
    return 1e3 * total / HBM_BYTES_PER_S, 1e3 * ops / FP64_OPS_PER_S


def k5_active(k_domain, call) -> int:
    """The (cell, value) pairs of a recorded launch with a correlate
    active (from the plain integer mode), for its operations bound."""
    _, _, con = k_domain.split_scores(k_domain.domain_scores_plain(call[1]),
                                      call[1].layout.cells,
                                      call[1].layout.va)
    return int(con.sum().item())


def k5_run(k_domain, call, plain=False):
    """One recorded K5 call, (mode, operands, beta, n_rows, extents), run
    again in its mode: the kernel's (or the plain version's) buffer."""
    mode, ops, beta, n_rows, _ = call
    if mode == "weak":
        fn = k_domain.weak_label_plain if plain else k_domain.weak_label
        return fn(ops, beta, n_rows)
    fn = k_domain.domain_scores_plain if plain else k_domain.domain_scores
    return fn(ops)


def k5_split(k_domain, call, buf):
    mode, ops = call[0], call[1]
    if mode == "weak":
        return k_domain.split_weak(buf, ops.layout.cells)
    return k_domain.split_scores(buf, ops.layout.cells, ops.layout.va)


def check_k5(torch, k_domain, call):
    """K5 in the mode its path launched against its plain version on the
    card, bitwise; returns the max |err| over the outputs' integers."""
    got = k5_run(k_domain, call)
    want = k5_run(k_domain, call, plain=True)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        fail(f"K5 ({call[0]} mode) differs from its plain version at "
             f"{call[1].layout}")
    return max(int((g.int() - w.int()).abs().max().item())
               if g.numel() else 0
               for g, w in zip(k5_split(k_domain, call, got),
                               k5_split(k_domain, call, want)))


def check_k5_host_route(torch, k_domain, call) -> int:
    """A weak-label launch against the host numpy route on the same
    operands: K5's integer mode, then ``_combine_scores`` and the host pick
    of ``compute_weak_label_mask`` per piece. Every cell's has_domain and
    every top of a cell with a domain must be equal. Returns the cells with
    a domain."""
    from delphi_tpu_torch.ops.domain import _combine_scores
    _, ops, beta, n_rows, _ = call
    lay = ops.layout
    has, top = (t.cpu().numpy() for t in k_domain.split_weak(
        k_domain.weak_label(ops, beta, n_rows), lay.cells))
    big, tiny, con = (t.cpu().numpy() for t in k_domain.split_scores(
        k_domain.domain_scores(ops), lay.cells, lay.va))
    rank = ops.rank.cpu().numpy().astype(np.int64)
    at, with_domain = 0, 0
    for p, (m, v_a) in enumerate(lay.extents):
        cells = slice(at, at + m)
        prob, contrib = _combine_scores(
            *(np.ascontiguousarray(a[cells, :v_a]) for a in (big, tiny, con)),
            n_rows)
        masked = np.where(contrib & (prob > beta), prob, -np.inf)
        best = masked.max(axis=1)
        want_has = best > -np.inf
        want_top = np.where(masked == best[:, None], rank[p, :v_a][None, :],
                            np.iinfo(np.int64).max).argmin(axis=1)
        if not np.array_equal(has[cells], want_has) or not np.array_equal(
                top[cells][want_has], want_top[want_has]):
            fail(f"K5's weak-label mode differs from the host numpy route "
                 f"on piece {p} of {lay}")
        with_domain += int(want_has.sum())
        at += m
    return with_domain


def k5_table_branches(torch, k_domain) -> dict:
    """Both table branches of K5, in both modes, bitwise against the plain
    version on the card: a piece whose pair tables fit the shared-memory
    budget and a synthetic one whose tables exceed it (read through
    ``__ldg`` and L2). Returns what each launched."""
    rng = np.random.default_rng(5)
    n_rows = 200_000
    out = {}
    # (k, real table rows, values): 46,848 bytes of tables against
    # 1,849,344, beside the 102,400-byte budget
    for branch, (k, vc, v_a) in (("shared", (3, 64, 60)),
                                 ("global", (3, 512, 300))):
        codes = torch.as_tensor(
            rng.integers(-1, vc - 1, (4, n_rows)).astype(np.int32),
            device="cuda")
        tables = rng.integers(0, 9, (k, vc, v_a + 1)).astype(np.int32)
        piece = k_domain.Piece(
            rows=rng.integers(0, n_rows, 50_000),
            col_idx=rng.choice(4, k, replace=False),
            taus=rng.integers(0, 3, k), vcs=[vc] * k,
            hs=rng.random(v_a) < 0.9, rank=rng.permutation(v_a),
            tables=tables)
        blob, layout = k_domain.pack([piece], vc)
        ops = k_domain.Operands(codes, torch.as_tensor(blob, device="cuda"),
                                layout)
        before = dict(k_domain.branch_launches)
        for mode in ("weak", "int"):
            check_k5(torch, k_domain,
                     (mode, ops, 1.5 / v_a, float(n_rows), []))
        launched = {b: k_domain.branch_launches[b] - before[b]
                    for b in before}
        if launched[branch] != 2:
            fail(f"K5 table branches: the {branch} case launched "
                 f"{launched}")
        out[branch] = {"k": k, "vc": vc, "v_a": v_a,
                       "table_bytes": 4 * k * vc * (v_a + 1),
                       "launches": launched}
    return out


def k5_bare(torch, k_domain, build, call):
    """One K5 launch through ctypes alone (its table built once)."""
    import ctypes
    mode, ops, beta, n_rows, _ = call
    weak = mode == "weak"
    template, shape = k_domain.params(ops, weak)
    t = k_domain.DomainTable.from_buffer_copy(template)
    out = torch.empty(k_domain.out_bytes(ops.layout, weak),
                      dtype=torch.uint8, device=ops.device)
    t.out, t.beta, t.n_rows = out.data_ptr(), beta or 0.0, n_rows or 0.0
    lib, stream = build.library(), build.current_stream()
    args = (ctypes.addressof(t), shape["grid"][0], shape["grid"][1],
            shape["smem"], stream)

    def launch():
        build.check(lib.delphi_domain_scores(*args), "domain_scores")
    launch.keep = (t, out, ops)
    return launch


def measure_k5(torch, k_domain, build, flush, call, label):
    """One K5 input in its path's mode: wrapper, kernel and plain times,
    and its bound (ms) from the launch's real pieces (:func:`k5_bound_ms`);
    no single library call computes it."""
    fn = lambda: k5_run(k_domain, call)  # noqa: E731
    weak = call[0] == "weak"
    bytes_ms, ops_ms = k5_bound_ms(
        call[4], weak, k5_active(k_domain, call) if weak else 0)
    row = {
        "mode": call[0],
        "ms": time_ms(torch, fn, flush),
        "host_ms": host_ms(torch, fn),
        "plain_ms": time_ms(
            torch, lambda: k5_run(k_domain, call, plain=True), flush),
        "library_ms": None,
        "bound_ms": max(bytes_ms, ops_ms),
        "bytes_ms": bytes_ms, "ops_ms": ops_ms,
    }
    defer_kernel_ms(f"K5 {label}", row, fn,
                    k5_bare(torch, k_domain, build, call),
                    ["domain_kernel"], 1)
    return row


def fused_keys(torch, codes, pairs, vocab):
    """The fused bin index of every (pair, row), offset per pair: the
    input of the one-call library yardstick for K1."""
    keys, base = [], 0
    for x, y in pairs:
        wy = vocab[y] + 1
        keys.append(base + (codes[x].long() + 1) * wy + (codes[y].long() + 1))
        base += (vocab[x] + 1) * wy
    return torch.cat(keys), base


def check_k1(torch, k_pair, codes, pairs, vocab):
    got, off = k_pair.pair_counts(codes, pairs, vocab)
    want, off_p = k_pair.pair_counts_plain(codes, pairs, vocab)
    torch.cuda.synchronize()
    if not np.array_equal(off, off_p) or not torch.equal(got, want):
        fail(f"K1 pair_counts differs from its plain version on {pairs} "
             f"(vocab {vocab}, n={codes.shape[1]})")
    if int(got.sum().item()) != len(pairs) * int(codes.shape[1]):
        fail("K1 pair_counts lost rows")
    return got, off, int((got - want).abs().max().item()) if got.numel() else 0


def check_k2(torch, k_entropy, counts, offsets, n_rows):
    h, tot, nnz = k_entropy.entropy_terms(counts, offsets, n_rows)
    h2, tot2, nnz2 = k_entropy.entropy_terms(counts, offsets, n_rows)
    hp, totp, nnzp = k_entropy.entropy_terms_plain(counts, offsets, n_rows)
    torch.cuda.synchronize()
    if not (torch.equal(h, h2) and torch.equal(tot, tot2)
            and torch.equal(nnz, nnz2)):
        fail("K2 entropy_terms differs between two calls on one input")
    if not (torch.equal(tot, totp) and torch.equal(nnz, nnzp)):
        fail("K2 entropy_terms totals differ from its plain version")
    if not torch.allclose(h, hp, rtol=1e-12, atol=0.0):
        fail(f"K2 entropy_terms outside 1e-12 relative: {h} vs {hp}")
    return float((h - hp).abs().max().item()) if h.numel() else 0.0


def measure_k1(torch, k_pair, build, flush, codes, pairs, vocab, label):
    """One K1 input: wrapper, kernel, plain and one-bincount times, and its
    bound (ms)."""
    key, total = fused_keys(torch, codes, pairs, vocab)
    fn = lambda: k_pair.pair_counts(codes, pairs, vocab)  # noqa: E731
    row = {
        "ms": time_ms(torch, fn, flush),
        "host_ms": host_ms(torch, fn),
        "plain_ms": time_ms(torch, lambda: k_pair.pair_counts_plain(
            codes, pairs, vocab), flush),
        "library_ms": time_ms(
            torch, lambda: torch.bincount(key, minlength=total), flush),
        "bound_ms": k1_bound_ms(codes, pairs, vocab),
    }
    del key
    plan = k_pair.plan_launches(tuple(map(tuple, pairs)), tuple(vocab))
    defer_kernel_ms(f"K1 {label}", row, fn,
                    k1_bare(torch, k_pair, build, codes, pairs, vocab),
                    ["pair_counts_kernel"], len(plan))
    return row


def measure_k2(torch, k_entropy, build, flush, counts, offsets, n_rows,
               label):
    """One K2 input: wrapper, kernel and plain times, and its bound (ms)."""
    bytes_ms, ops_ms = k2_bound_ms(counts, offsets)
    fn = lambda: k_entropy.entropy_terms(counts, offsets, n_rows)  # noqa
    row = {
        "ms": time_ms(torch, fn, flush),
        "host_ms": host_ms(torch, fn),
        "plain_ms": time_ms(torch, lambda: k_entropy.entropy_terms_plain(
            counts, offsets, n_rows), flush),
        "library_ms": None,
        "bytes_ms": bytes_ms, "ops_ms": ops_ms,
        "bound_ms": max(bytes_ms, ops_ms),
    }
    defer_kernel_ms(f"K2 {label}", row, fn,
                    k2_bare(torch, k_entropy, build, counts, offsets, n_rows),
                    ["entropy_terms_kernel"], 1)
    return row


_GBDT_SIGNATURES = {}


def gbdt_key(name, a) -> tuple:
    """The structure of one K3 / K4 call: every argument's shape and type
    with the row count left out, every scalar but a float (the
    hyperparameters' values do not change the code the kernel runs)."""
    def part(k, v):
        if hasattr(v, "shape"):
            shape = list(v.shape)
            if k in GBDT_ROW_AXIS:
                shape[GBDT_ROW_AXIS[k]] = "n"
            return tuple(shape), str(v.dtype)
        return v if isinstance(v, (int, bool, str)) or v is None \
            else type(v).__name__
    return (name,) + tuple(part(k, v) for k, v in a.items())


def gbdt_record(calls, name, fn, args, kwargs, copy=None) -> None:
    """Keeps the first call of each structure (:func:`gbdt_key`) of the
    K3 / K4 wrapper ``fn`` in ``calls`` (key -> (name, arguments)): split's
    output tables cloned (they fill level by level), or every tensor
    passed through ``copy`` (a rank's inputs go to the host)."""
    import inspect
    sig = _GBDT_SIGNATURES.get(name)
    if sig is None:
        sig = _GBDT_SIGNATURES[name] = inspect.signature(fn)
    bound = sig.bind(*args, **kwargs)
    bound.apply_defaults()
    a = dict(bound.arguments)
    key = gbdt_key(name, a)
    if key in calls:
        return
    if copy is not None:
        a = {k: copy(v) if hasattr(v, "shape") else v for k, v in a.items()}
    elif name == "split":
        a["feat"], a["thr"] = a["feat"].clone(), a["thr"].clone()
    calls[key] = (name, a)


def gbdt_run(k_gbdt, name, a, plain=False):
    """One recorded call run again (the wrapper, or the plain version);
    split writes into fresh copies of its recorded tables and returns
    them."""
    a = dict(a)
    if name == "split":
        a["feat"], a["thr"] = a["feat"].clone(), a["thr"].clone()
        (k_gbdt.split_plain if plain else k_gbdt.split)(
            **{("hist" if k == "hist_" and plain else k): v
               for k, v in a.items()})
        return a["feat"], a["thr"]
    fn = getattr(k_gbdt, name + "_plain" if plain else name)
    return (fn(**a),)


def gbdt_hold(torch, k_gbdt, calls, label):
    """Every recorded call (:func:`gbdt_record`) run again on the card and
    held bitwise against its plain version on the same tensors; fails on
    a difference. Returns ({kernel: {"calls_checked", "max_abs_err",
    "layouts", "max_nodes"}}, {kernel: (key, name, arguments) of its
    heaviest call by bound}); a layout is a histogram's channel count C,
    for split with its weight and count slots (C 2: the hessian is the
    weight; a count slot: ``min_child_samples``)."""
    held = {k: {"calls_checked": 0, "max_abs_err": 0.0, "layouts": [],
                "max_nodes": 0} for k in GBDT_KERNELS}
    heaviest = {}
    for key, (name, a) in calls.items():
        a = {k: v.cuda() if hasattr(v, "shape") else v for k, v in a.items()}
        got = gbdt_run(k_gbdt, name, a)
        want = gbdt_run(k_gbdt, name, a, plain=True)
        torch.cuda.synchronize()
        err = 0.0
        for g, w in zip(got, want):
            if g.dtype != w.dtype or g.shape != w.shape \
                    or not torch.equal(g, w):
                fail(f"{label}: {name} differs from its plain version at "
                     f"{key}")
            if g.dtype.is_floating_point and g.numel():
                err = max(err, float((g - w).abs().max().item()))
        kernel = "gbdt_" + name
        h = held[kernel]
        h["calls_checked"] += 1
        h["max_abs_err"] = max(h["max_abs_err"], err)
        layout = {"hist": lambda: int(a["vals"].shape[2]),
                  "split": lambda: [int(a["hist_"].shape[4]), a["w_slot"],
                                    a["c_slot"]]}.get(name)
        if layout is not None and layout() not in h["layouts"]:
            h["layouts"].append(layout())
        nodes = {"hist": lambda: a["n_level"],
                 "split": lambda: 1 << a["level"],
                 "route": lambda: 1 << a["level"]}.get(name)
        if nodes is not None:
            h["max_nodes"] = max(h["max_nodes"], nodes())
        bound = max(gbdt_bound_ms(name, a))
        if kernel not in heaviest or bound > heaviest[kernel][0]:
            heaviest[kernel] = (bound, key, name, a)
    return held, {k: v[1:] for k, v in heaviest.items()}


def gbdt_bound_ms(name, a):
    """(bytes ms, operations ms) of one recorded K3 / K4 call. Bytes:
    each input the function needs read once, each output written once.
    hist: the rows' channels (4 C bytes), node ids (4, none at the root)
    and each model's bins (8 a row and feature), the histograms out.
    split: the histograms in, feat and thr (8 bytes each) out a node.
    route: a row's node id in (none at the root) and out (4 bytes each)
    and the one bin its node's split reads (8), at most each model's bins
    once (the trees of a model share its matrix). predict: the bins, every
    tree's splits (16 bytes a node) and leaves (4), the margins out.
    Operations, over the FP32 rate: hist one add a row, feature and
    channel; split per bin and channel two scan adds, per bin the gain's
    eleven. Over the INT32 rate: route and predict two a node visit (the
    compare and the child index), T x n visits for route, R x T x n x
    depth for predict."""
    if name == "hist":
        v, node, bins = a["vals"], a["node"], a["bins"]
        T, n, C = v.shape
        d = 1 if bins is None else int(bins.shape[-1])
        models = 0 if bins is None else (1 if bins.dim() == 2
                                         else int(bins.shape[0]))
        nbytes = T * n * 4 * C + (0 if node is None else T * n * 4) \
            + models * n * d * 8 + T * a["n_level"] * d * a["n_bins"] * C * 4
        ops = T * n * d * C
    elif name == "split":
        T, L, d, B, C = a["hist_"].shape
        nbytes = T * L * d * B * C * 4 + T * L * 16
        ops = T * L * d * B * (2 * C + 11)
    elif name == "route":
        bins = a["bins"]
        T, n, d = a["feat"].shape[0], int(bins.shape[-2]), int(bins.shape[-1])
        models = 1 if bins.dim() == 2 else int(bins.shape[0])
        nbytes = T * n * (4 + (0 if a["node"] is None else 4)) \
            + min(T * n * 8, models * n * d * 8)
        return (1e3 * nbytes / HBM_BYTES_PER_S,
                1e3 * T * n * GBDT_OPS_PER_VISIT / INT32_OPS_PER_S)
    else:
        R, T, width = a["feats"].shape
        n, d = a["bins"].shape
        nbytes = n * d * 8 + R * T * (16 * width + 4 * (width + 1)) \
            + T * n * 4
        visits = R * T * n * a["depth"]
        return (1e3 * nbytes / HBM_BYTES_PER_S,
                1e3 * visits * GBDT_OPS_PER_VISIT / INT32_OPS_PER_S)
    return 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * ops / FP32_OPS_PER_S


def gbdt_library(torch, name, a):
    """One PyTorch call computing the same function as the recorded call,
    for ``library_ms`` (hist: ``index_add_`` over the flattened segment
    index, float atomics in another order; None for the others), built
    outside the timing."""
    if name != "hist":
        return None
    v, node, bins = a["vals"], a["node"], a["bins"]
    T, n, C = v.shape
    n_level, n_bins = a["n_level"], a["n_bins"]
    if bins is None:
        bins = torch.zeros((n, 1), dtype=torch.int64, device=v.device)
    tb = bins.expand(T, *bins.shape) if bins.dim() == 2 \
        else bins.repeat_interleave(a["per_round"], 0) if bins.shape[0] > 1 \
        else bins.expand(T, *bins.shape[1:])
    d = tb.shape[2]
    nd = torch.zeros((T, n), dtype=torch.int64, device=v.device) \
        if node is None else node
    seg = ((torch.arange(T, device=v.device)[:, None, None] * n_level
            + nd[:, :, None]) * d
           + torch.arange(d, device=v.device)[None, None, :]) * n_bins + tb
    seg = seg.reshape(-1)
    flat = v[:, :, None, :].expand(T, n, d, C).reshape(-1, C).contiguous()
    out = torch.zeros((T * n_level * d * n_bins, C), dtype=torch.float32,
                      device=v.device)
    return lambda: out.index_add_(0, seg, flat)


def gbdt_chain(torch, a) -> int:
    """The longest chain of dependent adds of one recorded K3a call: the
    rows of its fullest (tree, node, feature, bin)."""
    v, node, bins = a["vals"], a["node"], a["bins"]
    T, n, _ = v.shape
    n_level, n_bins = a["n_level"], a["n_bins"]
    if bins is None:
        bins = torch.zeros((n, 1), dtype=torch.int64, device=v.device)
    tb = bins.expand(T, *bins.shape) if bins.dim() == 2 \
        else bins.repeat_interleave(a["per_round"], 0) if bins.shape[0] > 1 \
        else bins.expand(T, *bins.shape[1:])
    d = tb.shape[2]
    nd = torch.zeros((T, n), dtype=torch.int64, device=v.device) \
        if node is None else node.long()
    seg = ((torch.arange(T, device=v.device)[:, None, None] * n_level
            + nd[:, :, None]) * d
           + torch.arange(d, device=v.device)[None, None, :]) * n_bins + tb
    return int(torch.bincount(seg.reshape(-1)).max().item()) if n else 0


def gbdt_edge_inputs(shape, seed):
    """vals, node, bins (CPU tensors) of one (T, per_round, n, d, n_bins, C,
    level, kind) shape: normal values with the last tenth of the rows 0
    (padding), uniform bins with column 1 a copy of column 0, uniform
    nodes. Kinds: "skew" puts about 80% of each feature's rows in bin 3,
    "empty" leaves node 1 without rows, "special" sets about 1% of the
    values to -0.0, +inf, -inf or NaN."""
    import torch
    T, per_round, n, d, n_bins, C, level, kind = shape
    rng = np.random.default_rng(seed)
    M = T // per_round
    vals = rng.normal(size=(T, n, C)).astype(np.float32)
    vals[:, -n // 10:] = 0.0
    bins = rng.integers(0, n_bins, (M, n, d))
    if kind == "skew":
        bins[rng.random((M, n, d)) < 0.8] = min(3, n_bins - 1)
    if d > 1:
        bins[:, :, 1] = bins[:, :, 0]
    node = rng.integers(0, 1 << level, (T, n)).astype(np.int32)
    if kind == "empty":
        node[node == 1] = 0
    if kind == "special":
        flat = vals.reshape(-1)
        at = rng.choice(flat.size, max(4, flat.size // 100), replace=False)
        flat[at] = np.resize(np.float32([-0.0, np.inf, -np.inf, np.nan]),
                             at.size)
    return (torch.from_numpy(vals), torch.from_numpy(node),
            torch.from_numpy(bins))


def gbdt_route_edge_inputs(shape, seed) -> dict:
    """The arguments of one K3c call (CPU tensors) of a GBDT_ROUTE_EDGES
    shape: node ids uniform over the level's nodes (None at level 0), the
    splits' features uniform, a table as wide as the level's tree at odd
    levels and one level deeper at even ones."""
    import torch
    T, per_round, n, d, n_bins, level, layout, kind = shape
    rng = np.random.default_rng(seed)
    width = (4 << level) - 1 if level % 2 == 0 else (2 << level) - 1
    lead = {"models": (T // per_round,), "shared": (), "one": (1,)}[layout]
    lo, hi = (-3, 70_000) if kind == "wide" else (0, n_bins)
    bins = rng.integers(lo, hi, lead + (n, d))
    thr = rng.integers(lo, hi + (0 if kind == "wide" else 1), (T, width))
    node = None if level == 0 else torch.from_numpy(
        rng.integers(0, 1 << level, (T, n)).astype(np.int32))
    return {"node": node, "bins": torch.from_numpy(bins),
            "feat": torch.from_numpy(rng.integers(0, d, (T, width))),
            "thr": torch.from_numpy(thr), "level": level,
            "per_round": per_round}


def gbdt_predict_edge_inputs(shape, seed) -> dict:
    """The arguments of one K4 call (CPU tensors) of a GBDT_PREDICT_EDGES
    shape: uniform bins and features, normal leaves and base margins."""
    import torch
    objective, T, R, depth, d, n, n_bins, kind = shape
    rng = np.random.default_rng(seed)
    W = (1 << depth) - 1
    bins = rng.integers(0, n_bins, (n, d))
    if kind == "thr":
        thrs = rng.choice(np.array([0, n_bins - 1, n_bins]), (R, T, W))
    else:
        thrs = rng.integers(0, n_bins + 1, (R, T, W))
    leaves = rng.normal(0, 0.3, (R, T, W + 1)).astype(np.float32)
    if kind == "special":
        flat = leaves.reshape(-1)
        at = rng.choice(flat.size, max(4, flat.size // 100), replace=False)
        flat[at] = np.resize(np.float32([-0.0, np.inf, -np.inf, np.nan]),
                             at.size)
    return {"bins": torch.from_numpy(bins),
            "feats": torch.from_numpy(rng.integers(0, d, (R, T, W))),
            "thrs": torch.from_numpy(thrs.astype(np.int64)),
            "leaves": torch.from_numpy(leaves), "depth": depth,
            "base": torch.from_numpy(rng.normal(size=T).astype(np.float32)),
            "multiclass": objective == "multiclass"}


def same_bits(torch, a, b) -> bool:
    """Equal bit for bit, a NaN equal to any NaN (the CPU's and the card's
    adds make NaNs of other payloads)."""
    nan_a, nan_b = torch.isnan(a), torch.isnan(b)
    return torch.equal(nan_a, nan_b) and torch.equal(
        torch.where(nan_a, 0.0, a).view(torch.int32),
        torch.where(nan_b, 0.0, b).view(torch.int32))


def gbdt_edges(torch, k_gbdt) -> dict:
    """4b: K3a and K3b at their edges (GBDT_EDGES) on the card against
    their plain versions on the same card tensors: the level's histograms
    and the leaf sums (no bins) bit for bit, NaN equal to NaN; the split
    search on each level's histograms (a hessian-like channel appended at
    C = 1) with the weight and count masks and without, feat / thr equal;
    one bin leaves every node the sentinel. Fails on a difference. These
    launches come after every traced path and count in no path's
    launches. Returns the calls checked and each shape's longest chain."""
    calls = {"hist": 0, "split": 0}
    chains = []
    for shape in GBDT_EDGES:
        T, per_round, n, d, n_bins, C, level, kind = shape
        vals, node, bins = (x.cuda() for x in
                            gbdt_edge_inputs(shape, sum(shape[:7])))
        L = 1 << level
        hist_calls = ((vals, node, bins, L, n_bins),
                      (vals[..., :min(C, 2)].contiguous(), node, None, L, 1))
        for v, nd, b, levels, nb in hist_calls:
            got = k_gbdt.hist(v, nd, b, levels, nb, per_round)
            want = k_gbdt.hist_plain(v, nd, b, levels, nb, per_round)
            torch.cuda.synchronize()
            if not same_bits(torch, got, want):
                fail(f"4b: gbdt_hist differs from its plain version at the "
                     f"edge {shape} ({'leaf sums' if b is None else 'level'})")
            calls["hist"] += 1
            if b is not None:
                level_hist = want
        chains.append(gbdt_chain(torch, {"vals": vals, "node": node,
                                         "bins": bins, "n_level": L,
                                         "n_bins": n_bins,
                                         "per_round": per_round}))
        h = level_hist.clone() if C > 1 \
            else torch.cat([level_hist, level_hist], -1)
        Cs = h.shape[-1]
        h[..., 1] = h[..., 1].abs() + 0.01
        if Cs > 2:
            h[..., 2] = h[..., 2].abs()
        lam_t = torch.from_numpy(np.random.default_rng(T).uniform(
            0.1, 1.1, T).astype(np.float32)).cuda()
        for w_slot, c_slot, lam, mcw in (
                (1 if Cs == 2 else 2, Cs - 1 if Cs == 4 else -1, 1.0, 0.5),
                (-1, -1, lam_t, 0.0)):
            tabs = [torch.zeros((T, 2 * L - 1), dtype=torch.int64,
                                device="cuda") for _ in range(4)]
            tabs[2].fill_(n_bins)
            tabs[3].fill_(n_bins)
            k_gbdt.split(h, tabs[0], tabs[2], level, n_bins, lam, 0.0, mcw,
                         2.0, w_slot, c_slot)
            k_gbdt.split_plain(h, tabs[1], tabs[3], level, n_bins, lam, 0.0,
                               mcw, 2.0, w_slot, c_slot)
            torch.cuda.synchronize()
            if not (torch.equal(tabs[0], tabs[1])
                    and torch.equal(tabs[2], tabs[3])):
                fail(f"4b: gbdt_split differs from its plain version at the "
                     f"edge {shape}")
            if n_bins == 1 and not (tabs[2] == 1).all():
                fail(f"4b: gbdt_split split a one-bin histogram at {shape}")
            calls["split"] += 1
    return {"shapes": len(GBDT_EDGES), "calls": calls,
            "longest_chains": chains}


def gbdt_route_edges(torch, k_gbdt) -> dict:
    """4b: K3c and K4 at their edges (GBDT_ROUTE_EDGES, GBDT_PREDICT_EDGES)
    on the card against their plain versions on the same card tensors, bit
    for bit (NaN equal to NaN), one launch a call; K3c at level 0 with node
    ids None and zeros. Fails on a difference. These launches come after
    every traced path and count in no path's launches. Returns the shapes
    and the calls checked."""
    calls = {"route": 0, "predict": 0}
    cases = [("route", shape) for shape in GBDT_ROUTE_EDGES] \
        + [("predict", shape) for shape in GBDT_PREDICT_EDGES]
    for name, shape in cases:
        a = gbdt_route_edge_inputs(shape, sum(shape[:6])) if name == "route" \
            else gbdt_predict_edge_inputs(shape, sum(shape[1:7]))
        a = {k: v.cuda() if hasattr(v, "shape") else v for k, v in a.items()}
        variants = [a]
        if name == "route" and a["node"] is None:
            n = int(a["bins"].shape[-2])
            variants.append(dict(a, node=torch.zeros(
                (a["feat"].shape[0], n), dtype=torch.int32, device="cuda")))
        for v in variants:
            before = k_gbdt.launches["gbdt_" + name]
            got = getattr(k_gbdt, name)(**v)
            want = getattr(k_gbdt, name + "_plain")(**v)
            torch.cuda.synchronize()
            launched = k_gbdt.launches["gbdt_" + name] - before
            if launched != 1:
                fail(f"4b: gbdt_{name} launched {launched} times at the edge "
                     f"{shape}")
            if got.dtype != want.dtype or got.shape != want.shape \
                    or not (same_bits(torch, got, want)
                            if got.dtype.is_floating_point
                            else torch.equal(got, want)):
                fail(f"4b: gbdt_{name} differs from its plain version at the "
                     f"edge {shape}")
            calls[name] += 1
        del a, variants
    return {"route_shapes": len(GBDT_ROUTE_EDGES),
            "predict_shapes": len(GBDT_PREDICT_EDGES), "calls": calls}


def gbdt_bare(k_gbdt, build, name, a):
    """The recorded call's kernel launch through ctypes alone (its table
    prepared once)."""
    import ctypes
    if name == "split":
        a = dict(a, feat=a["feat"].clone(), thr=a["thr"].clone())
        p, keep = k_gbdt.split_params(**a), a
    else:
        p, keep = getattr(k_gbdt, name + "_params")(**a)
    lib, stream = build.library(), build.current_stream()
    fn = getattr(lib, f"delphi_gbdt_{name}")

    def launch():
        return fn(ctypes.addressof(p), stream)
    launch.keep = keep  # the tensors the table points at stay allocated
    return launch


# --gbdt-probe: (label, T, per_round, n, d, n_bins, C, level, kind) of
# K3a calls timed with the K3b call on their histograms: 4e's CV launch
# (3 folds x 8 class trees, 10,000 rows, 4 features, 64 bins) at its root
# and fifth level, its leaf sums at depth 5 ("leaf": no bins, one bin, C
# 2), the gauntlet's wide width (55 features) and a bin holding 80% of
# the rows
GBDT_PROBE = [("4e root", 24, 8, 10_000, 4, 64, 3, 0, ""),
              ("4e level 4", 24, 8, 10_000, 4, 64, 3, 4, ""),
              ("4e leaf sums", 24, 8, 10_000, 4, 64, 2, 5, "leaf"),
              ("wide level 2", 24, 4, 10_000, 55, 64, 3, 2, ""),
              ("skew root", 24, 8, 10_000, 4, 64, 3, 0, "skew"),
              ("skew level 4", 24, 8, 10_000, 4, 64, 3, 4, "skew")]


# --gbdt-probe's K3c and K4 calls: (label, kernel, shape of
# GBDT_ROUTE_EDGES / GBDT_PREDICT_EDGES): 4e's CV launch at levels 0, 1 and
# 4, the gauntlet's wide width, 72 one-tree models (the batched fits); K4
# at the main path's prediction (220,000 rows, 25 rounds of 8 class trees,
# depth 5), at the constraints run's (about 1,000,000 rows, 50 rounds of 8
# at depth 3) and at the gauntlet's width (50 rounds of 4, 55 features)
GBDT_PROBE_RP = [
    ("4e root", "route", (24, 8, 10_000, 4, 64, 0, "models", "")),
    ("4e level 1", "route", (24, 8, 10_000, 4, 64, 1, "models", "")),
    ("4e level 4", "route", (24, 8, 10_000, 4, 64, 4, "models", "")),
    ("wide level 2", "route", (24, 4, 10_000, 55, 64, 2, "models", "")),
    ("batched level 3", "route", (72, 1, 10_000, 4, 64, 3, "models", "")),
    ("e2e", "predict", ("multiclass", 8, 25, 5, 4, 220_000, 64, "")),
    ("constraints", "predict",
     ("multiclass", 8, 50, 3, 4, 1_000_000, 64, "")),
    ("wide", "predict", ("multiclass", 4, 50, 5, 55, 50_000, 64, ""))]


def parent_gbdt_library(build, parent):
    """``--gbdt-probe --parent DIR``: the parent tree's ``csrc/gbdt.cu``
    built alone with this tree's flags and loaded. Its K3c / K4 entry
    points take the same parameter tables (their layouts are unchanged)."""
    import ctypes
    out = os.path.join(HERE, "build", "parent_gbdt")
    os.makedirs(out, exist_ok=True)
    path = os.path.join(out, "libparent_gbdt.so")
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-shared", "-o", path,
                    os.path.join(parent, "delphi_tpu_torch", "csrc",
                                 "gbdt.cu")],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(path)
    for name in ("delphi_gbdt_route", "delphi_gbdt_predict"):
        getattr(lib, name).restype = ctypes.c_int
        getattr(lib, name).argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    return lib


def gbdt_rp_row(torch, k_gbdt, build, flush, label, name, a, floor,
                parent=None) -> dict:
    """One K3c / K4 call of --gbdt-probe, held bitwise against its plain
    version on the card, then timed from back-to-back bare launches beside
    its byte and operation bounds and the empty kernel's launch floor
    (``floor``: its bare and device times);
    with ``parent`` (:func:`parent_gbdt_library`) the parent's kernel is
    held and timed on the same inputs too (``parent_ms``)."""
    import ctypes
    got = getattr(k_gbdt, name)(**a)
    want = getattr(k_gbdt, name + "_plain")(**a)
    torch.cuda.synchronize()

    def same(x):
        return same_bits(torch, x, want) if x.dtype.is_floating_point \
            else torch.equal(x, want)
    if not same(got):
        fail(f"--gbdt-probe: gbdt_{name} differs at {label}")
    bytes_ms, ops_ms = gbdt_bound_ms(name, a)
    bare = gbdt_bare(k_gbdt, build, name, a)
    kernel = f"gbdt_{name}_kernel"
    row = {"label": f"{label} gbdt_{name}",
           "ms": bare_ms(torch, bare, flush),
           "device_ms": device_ms(torch, bare, flush, kernel),
           "device_warm_ms": device_ms(torch, bare, None, kernel),
           "bytes_ms": bytes_ms, "ops_ms": ops_ms,
           "bound_ms": max(bytes_ms, ops_ms), **floor}
    if parent is not None:
        p, out = getattr(k_gbdt, name + "_params")(**a)
        fn = getattr(parent, f"delphi_gbdt_{name}")
        stream = build.current_stream()
        build.check(fn(ctypes.addressof(p), stream), f"parent {name}")
        torch.cuda.synchronize()
        if not same(out if name == "route" or a["multiclass"] else out[0]):
            fail(f"--gbdt-probe: the parent's gbdt_{name} differs at {label}")
        launch = lambda: fn(ctypes.addressof(p), stream)  # noqa: E731
        row["parent_ms"] = bare_ms(torch, launch, flush)
        row["parent_device_ms"] = device_ms(torch, launch, flush, kernel)
        row["parent_device_warm_ms"] = device_ms(torch, launch, None, kernel)
    return row


HIST_PHASES = ("windows", "bins", "rank", "scan", "place", "walk", "output")


def hist_clocks(torch, k_gbdt, build, a) -> dict:
    """The slowest block's cycles by phase in one K3a launch of ``a``, when
    the library was built with -DDELPHI_GBDT_PHASE_CLOCKS (else {})."""
    import ctypes
    lib = build.library()
    if not hasattr(lib, "delphi_gbdt_hist_clocks"):
        return {}
    buf = (ctypes.c_ulonglong * (len(HIST_PHASES) + 2))()
    k_gbdt.hist(**a)
    torch.cuda.synchronize()
    lib.delphi_gbdt_hist_clocks(buf)
    k_gbdt.hist(**a)
    torch.cuda.synchronize()
    lib.delphi_gbdt_hist_clocks(buf)
    return {"blocks": buf[-1], "slowest_block_cycles": dict(
        zip(HIST_PHASES + ("total",), buf[:-1]))}


def device_ms(torch, launch, flush, name, reps: int = 20):
    """The mean device time of one bare launch from ``torch.profiler``'s
    kernel records (the L2 flushed before each, as for ``kernel_ms``; with
    ``flush`` None, back to back): back-to-back bare launches of a kernel
    shorter than the host's enqueue time the host. None unless one record
    a launch names ``name``."""
    from torch.profiler import ProfilerActivity, profile
    from delphi_tpu_torch.utils import profiling
    launch()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        profiling.prime(torch)
        for _ in range(reps):
            if flush is not None:
                flush.zero_()
            launch()
        torch.cuda.synchronize()
    d = [e.end_ns - e.start_ns for e in
         profiling.drop_primer(profiling.profiler_events(prof))
         if e.kind == profiling.KERNEL and name in e.name]
    return sum(d) / len(d) / 1e6 if len(d) == reps else None


def gbdt_probe(torch, k_gbdt, build, flush, parent=None) -> list:
    """``python3 chip_smoke.py --gbdt-probe``: each GBDT_PROBE call of K3a
    and the K3b call on its histograms checked bitwise against the plain
    versions, then timed: kernel ms from back-to-back bare launches,
    ``index_add_`` for K3a, the byte bound and K3a's order floor."""
    rows = []
    lib, stream = build.library(), build.current_stream()
    empty = lambda: lib.delphi_launch_floor(stream)  # noqa: E731
    floor = {"launch_floor_ms": bare_ms(torch, empty, flush),
             "launch_floor_device_ms": device_ms(torch, empty, flush,
                                                 "empty_kernel")}
    log(f"[gbdt-probe] launch floor (empty kernel): {fmt(floor)}")
    for label, name, shape in GBDT_PROBE_RP:
        a = gbdt_route_edge_inputs(shape, sum(shape[:6])) if name == "route" \
            else gbdt_predict_edge_inputs(shape, sum(shape[1:7]))
        a = {k: v.cuda() if hasattr(v, "shape") else v for k, v in a.items()}
        row = gbdt_rp_row(torch, k_gbdt, build, flush, label, name, a, floor,
                          parent)
        log(f"[gbdt-probe] {row['label']}: {fmt(row)}")
        rows.append(row)
    for label, *shape in GBDT_PROBE:
        T, per_round, n, d, n_bins, C, level, kind = shape
        vals, node, bins = (x.cuda() for x in gbdt_edge_inputs(
            (T, per_round, n, d, n_bins, C, level,
             "" if kind == "leaf" else kind), sum(shape[:7])))
        if kind == "leaf":
            a = {"vals": vals, "node": node, "bins": None,
                 "n_level": 1 << level, "n_bins": 1, "per_round": 1}
        else:
            a = {"vals": vals, "node": None if level == 0 else node,
                 "bins": bins, "n_level": 1 << level, "n_bins": n_bins,
                 "per_round": per_round}
        got = k_gbdt.hist(**a)
        want = k_gbdt.hist_plain(**a)
        torch.cuda.synchronize()
        if not same_bits(torch, got, want):
            fail(f"--gbdt-probe: gbdt_hist differs at {label}")
        bytes_ms, ops_ms = gbdt_bound_ms("hist", a)
        row = {"label": label, **hist_clocks(torch, k_gbdt, build, a),
               "hist_ms": bare_ms(torch, gbdt_bare(k_gbdt, build, "hist", a),
                                  flush),
               "index_add_ms": time_ms(torch, gbdt_library(torch, "hist", a),
                                       flush),
               "hist_bound_ms": max(bytes_ms, ops_ms),
               "order_chain": gbdt_chain(torch, a)}
        row["order_floor_ms"] = row["order_chain"] * ADD_NS[0] / 1e6
        if kind != "leaf":
            h = want.clone()
            h[..., 1] = h[..., 1].abs() + 0.01
            h[..., 2] = h[..., 2].abs()
            L = 1 << level
            sa = {"hist_": h, "level": level, "n_bins": n_bins,
                  "reg_lambda": 1.0, "min_split_gain": 0.0,
                  "min_child_weight": 0.5, "min_child_samples": 0.0,
                  "w_slot": 2, "c_slot": -1,
                  "feat": torch.zeros((T, 2 * L - 1), dtype=torch.int64,
                                      device="cuda"),
                  "thr": torch.full((T, 2 * L - 1), n_bins,
                                    dtype=torch.int64, device="cuda")}
            g_f, g_t = gbdt_run(k_gbdt, "split", sa)
            w_f, w_t = gbdt_run(k_gbdt, "split", sa, plain=True)
            torch.cuda.synchronize()
            if not (torch.equal(g_f, w_f) and torch.equal(g_t, w_t)):
                fail(f"--gbdt-probe: gbdt_split differs at {label}")
            row["split_ms"] = bare_ms(torch, gbdt_bare(k_gbdt, build,
                                                       "split", sa), flush)
            row["split_bound_ms"] = max(gbdt_bound_ms("split", sa))
        log(f"[gbdt-probe] {label}: {fmt(row)}")
        rows.append(row)
    # real calls: phase 4's 1M repair, 4f's 1M constraints run and the
    # gauntlet's wide scenario at the top of its scale series (4t(b)),
    # recorded as 4b records them, the heaviest call of each kernel timed
    # the same way
    import delphi_tpu_torch as T
    from delphi_tpu_torch.gauntlet import SCENARIOS, generate_scenario
    from delphi_tpu_torch.gauntlet import runner
    T.set_device("cuda")
    _, dirty = missing_heavy(E2E_ROWS, seed=0)
    _, dc_dirty, _ = fd_table(DC_ROWS, seed=4)
    wide = generate_scenario("wide", max(SCENARIOS["wide"].scales), 0)

    def gauntlet_wide():
        with downstream_or_null():
            runner.run_scenario(wide, seed=0)
    for path, run in (("e2e", lambda: repair(T, dirty)),
                      ("constraints", lambda: dc_model(T, dc_dirty).run()),
                      ("gauntlet wide", gauntlet_wide)):
        calls = {}
        orig = {name: getattr(k_gbdt, name)
                for name in ("hist", "split", "route", "predict")}

        def recording(name):
            def fn(*args, **kwargs):
                gbdt_record(calls, name, orig[name], args, kwargs)
                return orig[name](*args, **kwargs)
            return fn
        try:
            for name in orig:
                setattr(k_gbdt, name, recording(name))
            run()
        finally:
            for name, fn in orig.items():
                setattr(k_gbdt, name, fn)
        _, heaviest = gbdt_hold(torch, k_gbdt, calls, f"--gbdt-probe {path}")
        for kernel, (key, name, a) in sorted(heaviest.items()):
            if name in ("route", "predict"):
                row = gbdt_rp_row(torch, k_gbdt, build, flush, path, name, a,
                                  floor, parent)
                row["shape"] = [list(x) if isinstance(x, tuple) else x
                                for x in key[1:]]
                log(f"[gbdt-probe] {row['label']}: {fmt(row)}")
                rows.append(row)
                continue
            clk = hist_clocks(torch, k_gbdt, build, a) if name == "hist" else {}
            row = {"label": f"{path} {kernel}", **clk, "ms": bare_ms(
                torch, gbdt_bare(k_gbdt, build, name, a), flush),
                   "bound_ms": max(gbdt_bound_ms(name, a))}
            if name == "hist":
                row["index_add_ms"] = time_ms(
                    torch, gbdt_library(torch, name, a), flush)
                row["order_chain"] = gbdt_chain(torch, a)
                row["order_floor_ms"] = row["order_chain"] * ADD_NS[0] / 1e6
            log(f"[gbdt-probe] {row['label']}: {fmt(row)}")
            rows.append(row)
    return rows


def gbdt_measure(torch, k_gbdt, build, flush, label, key, name, a):
    """4b for K3 and K4: one recorded call (a path's heaviest of its
    kernel, already held bitwise by :func:`gbdt_hold`) timed: ms, host,
    plain, ``index_add_`` for K3a, the bound; its kernel_ms deferred."""
    bytes_ms, ops_ms = gbdt_bound_ms(name, a)
    fn = lambda: gbdt_run(k_gbdt, name, a)  # noqa: E731
    lib_fn = gbdt_library(torch, name, a)
    row = {
        "ms": time_ms(torch, fn, flush), "host_ms": host_ms(torch, fn),
        "plain_ms": time_ms(torch, lambda: gbdt_run(k_gbdt, name, a,
                                                    plain=True), flush),
        "library_ms": None if lib_fn is None
        else time_ms(torch, lib_fn, flush),
        "bytes_ms": bytes_ms, "ops_ms": ops_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "shape": [list(x) if isinstance(x, tuple) else x for x in key[1:]]}
    if name == "hist":
        # the order floor: the longest chain of dependent adds
        row["order_chain"] = gbdt_chain(torch, a)
        row["order_floor_ms"] = row["order_chain"] * ADD_NS[0] / 1e6
    kernel = "gbdt_" + name
    defer_kernel_ms(f"{kernel} {label}", row, fn,
                    gbdt_bare(k_gbdt, build, name, a), [kernel + "_kernel"],
                    1)
    log(f"[{label}-kernels] {kernel} heaviest call {key[1:]}: "
        f"{fmt({k: v for k, v in row.items() if k != 'shape'})}")
    return row


# ---------------------------------------------------------------------------
# K10: the logistic head's gather step and the Adam step
# ---------------------------------------------------------------------------

K10_KERNELS = ("logreg_forward", "logreg_backward", "adam_step")
# the path whose fit 4d gates: the 200,000-row zones table
K10_MAIN_PATH = "logistic"
K10_REPLACES = {
    "logreg_forward": "_fit_logreg_gather's loss :137-143 (jitted XLA, not "
                      "Pallas)",
    "logreg_backward": "the loss's jax.value_and_grad :155 (jitted XLA, not "
                       "Pallas)",
    "adam_step": "optax.adam's update :133, :156-157, and :58 / :194, the "
                 "dense and MLP fits (jitted XLA, not Pallas)"}
# (n, F, C, V, k, kind) of LOGREG_EDGES: 4d's shape, k 8 and 1,024 (a
# target of about 1,000 values), no continuous column, n = 1 with one
# vocabulary id, an id with no occurrence, rows of zero weight (labels in
# a class of weight 0), ±0.0 weights (all-zero logits of both signs),
# and large logits (weights of about ±1e4: most exponentials underflow);
# then the corners of K10b's ring and groups: two binary features at
# 50,000 rows (chains of about 25,000 occurrences, the ring wrapping many
# times), k 41 and 2 (a last group of 1 or 2 of its 8 classes), ids of
# exactly one ring stage of occurrences and one less and one more
# ("stage"), and 20,000 ids of about two occurrences each at k 8; then
# K10a's other routes and K10b's block an id: k 128 with the weights
# staged and binary features (chains of about 5,000 occurrences, several
# of K10b's row stages), k 200 with 81.6 KB of weights (not staged: the
# rows kernel), and 33 and 1,032 chunks of 32 classes (deep stacks of its
# class tree)
LOGREG_EDGES = [(10_000, 3, 1, 25, 40, ""),
                (10_000, 3, 1, 25, 8, ""),
                (2_000, 2, 0, 60, 1_024, ""),
                (1, 1, 1, 1, 8, ""),
                (300, 2, 2, 12, 40, "unseen"),
                (500, 2, 1, 10, 16, "zero_w"),
                (400, 2, 1, 10, 24, "signed_zero"),
                (400, 2, 1, 10, 24, "large"),
                (50_000, 2, 1, 4, 40, ""),
                (3_000, 3, 1, 25, 41, ""),
                (3_000, 3, 1, 25, 2, ""),
                (2_000, 2, 1, 20, 40, "stage"),
                (20_000, 2, 1, 20_000, 8, ""),
                (10_000, 2, 1, 4, 128, ""),
                (2_000, 2, 1, 100, 200, ""),
                (500, 2, 0, 4, 1_056, ""),
                (64, 1, 0, 2, 33_000, "")]
# Adam steps each edge's update is taken at
LOGREG_EDGE_STEPS = (1, 37)


def logreg_edge_inputs(shape, seed) -> dict:
    """CPU tensors of one LOGREG_EDGES shape: ids of F features over V
    (a share of V each, at least one id; "stage": the first feature's
    first three ids held by exactly RING_STAGE, RING_STAGE - 1 and
    RING_STAGE + 1 rows), labels in the first k
    - 2 classes (the last two padded, weight 0; "zero_w": a third of the
    rows labelled in a class of weight 0), balanced weights, normal
    weights (scaled by the kind), the host's denom."""
    import torch
    from delphi_tpu_torch.ops.kernels import linear as k_lin
    n, F, C, V, k, kind = shape
    rng = np.random.default_rng(seed)
    sizes = V // F + (np.arange(F) < V % F)   # V >= F: an id or more each
    offsets = np.concatenate([[0], np.cumsum(sizes[:-1])])
    gid = (offsets + np.stack([rng.integers(0, s, n) for s in sizes], 1)) \
        .astype(np.int64)
    if kind == "unseen":
        gid[gid == 1] = 0
    if kind == "stage":
        s = k_lin.RING_STAGE
        col = np.concatenate([np.zeros(s), np.ones(s - 1), np.full(s + 1, 2),
                              rng.integers(3, sizes[0], n - 3 * s)])
        gid[:, 0] = offsets[0] + rng.permutation(col).astype(np.int64)
    real = max(k - 2, 1)
    y = rng.integers(0, real, n).astype(np.int64)
    counts = np.bincount(y, minlength=k).astype(np.float64)
    cw = np.zeros(k, np.float32)
    cw[:real] = np.where(counts[:real] > 0,
                         n / (real * np.maximum(counts[:real], 1)), 0.0)
    if kind == "zero_w":
        cw[0] = 0.0
        y[: n // 3] = 0
    sw = cw[y].astype(np.float32)
    scale = {"large": 1e4, "signed_zero": 0.0}.get(kind, 0.5)
    weights = [(rng.standard_normal(s) * scale).astype(np.float32)
               for s in ((V, k), (C, k), (k,))]
    if kind == "signed_zero":
        weights = [np.where(rng.random(w.shape) < 0.5, np.float32(-0.0),
                            np.float32(0.0)) for w in weights]
    t = {"gid": torch.from_numpy(gid),
         "cont": torch.from_numpy(rng.standard_normal((n, C))
                                  .astype(np.float32)),
         "y": torch.from_numpy(y), "sample_w": torch.from_numpy(sw),
         "Wcat": torch.from_numpy(weights[0]),
         "Wcont": torch.from_numpy(weights[1]),
         "b": torch.from_numpy(weights[2])}
    t["denom"] = max(float(k_lin.tree_sum(t["sample_w"])), 1.0)
    t["l2"], t["V"], t["k"] = 1e-4, V, k
    return t


def k10_key(name, args) -> tuple:
    """The structure of one K10 call: the design's shape but its row
    count (features, continuous columns, ids, classes); K10c's length."""
    if name == "adam_step":
        return (name, int(args[0].numel()))
    plan = args[0]
    return (name, int(plan.gid.shape[1]), int(plan.cont.shape[1]),
            plan.n_vocab, plan.k)


def k10_record(calls, name, args) -> None:
    """Keeps the first call of each structure (:func:`k10_key`) of a K10
    wrapper in ``calls`` (key -> (name, inputs)), its tensors cloned: the
    fit's buffers move on every step."""
    key = k10_key(name, args)
    if key in calls:
        return
    if name == "logreg_forward":
        plan, Wcat, Wcont, b = args[:4]
        a = (plan, Wcat.clone(), Wcont.clone(), b.clone())
    elif name == "logreg_backward":
        plan, dl, Wcat, Wcont = args[:4]
        a = (plan, dl.clone(), Wcat.clone(), Wcont.clone())
    else:
        params, grads, mu, nu, lr, t = args
        a = (params.clone(), grads.clone(), mu.clone(), nu.clone(), lr, t)
    calls[key] = (name, a)


def k10_outputs(torch, name, a):
    """Fresh outputs of one recorded call (K10c's: copies of its
    parameters and moments, updated in place)."""
    if name == "adam_step":
        return tuple(x.clone() for x in (a[0], a[2], a[3]))
    plan = a[0]
    n, dev = int(plan.gid.shape[0]), plan.gid.device
    if name == "logreg_forward":
        return (torch.empty(1, device=dev),
                torch.empty((n, plan.k), device=dev))
    return (torch.empty_like(a[2]), torch.empty_like(a[3]),
            torch.empty(plan.k, device=dev))


def k10_call(k_lin, name, a, out, plain=False) -> None:
    """One recorded call into ``out`` (the wrapper, or the plain
    version)."""
    fn = getattr(k_lin, name + "_plain" if plain else name)
    if name == "adam_step":
        params, grads, _, _, lr, t = a
        p, mu, nu = out
        fn(p, grads, mu, nu, lr, t)
    else:
        fn(*a, *out)


def k10_held(torch, k_lin, name, a, label) -> float:
    """One call on the card against its plain version on the same card
    tensors, bit for bit (NaN equal to NaN); fails on a difference.
    Returns the largest |difference| over the finite outputs."""
    got, want = k10_outputs(torch, name, a), k10_outputs(torch, name, a)
    k10_call(k_lin, name, a, got)
    k10_call(k_lin, name, a, want, plain=True)
    torch.cuda.synchronize()
    err = 0.0
    for g, w in zip(got, want):
        if g.shape != w.shape or not same_bits(torch, g, w):
            fail(f"{label}: {name} differs from its plain version")
        both = torch.isfinite(g) & torch.isfinite(w)
        if both.any():
            err = max(err, float((g[both] - w[both]).abs().max().item()))
    return err


def k10_hold(torch, k_lin, calls, label):
    """Every recorded K10 call (:func:`k10_record`) held bitwise against
    its plain version on the card. Returns ({kernel: {"calls_checked",
    "max_abs_err", "shapes"}}, {kernel: (key, name, inputs) of its
    heaviest call by bound})."""
    held = {k: {"calls_checked": 0, "max_abs_err": 0.0, "shapes": []}
            for k in K10_KERNELS}
    heaviest = {}
    for key, (name, a) in calls.items():
        h = held[name]
        h["max_abs_err"] = max(h["max_abs_err"],
                               k10_held(torch, k_lin, name, a, label))
        h["calls_checked"] += 1
        h["shapes"].append(list(key[1:]))
        bound = max(k10_bound_ms(name, a))
        if name not in heaviest or bound > heaviest[name][0]:
            heaviest[name] = (bound, key, name, a)
    return held, {k: v[1:] for k, v in heaviest.items()}


def k10_bound_ms(name, a):
    """(bytes ms, operations ms) of one K10 call. Bytes: each input read
    once, each output written once. K10a: gid (8 bytes a row and
    feature), cont (4 a row and column), y and sample_w (12 a row) and
    the weights in, dlogits and the loss out. K10b: dlogits, the
    occurrence rows (8 each), the offsets (8 an id), cont and the weights
    in, the three gradients out. K10c: parameters, gradients and both
    moments in, parameters and moments out (28 bytes a parameter).
    Operations over the FP32 rate: K10a per (row, class) F - 1 + 2 C + 1
    for the logit, the max, the subtraction, the class sum's add, the
    division and the multiply (F + 2 C + 5), and two a weight (its
    square, its add); its exp a (row, class) and its log a row over the
    FP64 rate. K10b per (row, class) F adds of the gathered sums and C
    multiplies and C + 1 adds of the row trees (F + 2 C + 1), three a
    weight (the L2 term). K10c twelve a parameter."""
    if name == "adam_step":
        N = int(a[0].numel())
        return 1e3 * 28 * N / HBM_BYTES_PER_S, 1e3 * 12 * N / FP32_OPS_PER_S
    plan = a[0]
    n, F = (int(x) for x in plan.gid.shape)
    C, V, k = int(plan.cont.shape[1]), plan.n_vocab, plan.k
    weights = (V + C + 1) * k * 4
    if name == "logreg_forward":
        nbytes = n * F * 8 + n * C * 4 + n * 12 + weights + n * k * 4 + 4
        ops = n * k * (F + 2 * C + 5) + 2 * (V + C) * k
        f64 = n * k + n
        return (1e3 * nbytes / HBM_BYTES_PER_S,
                1e3 * ops / FP32_OPS_PER_S + 1e3 * f64 / FP64_OPS_PER_S)
    nbytes = n * k * 4 + n * F * 8 + (V + 1) * 8 + n * C * 4 + weights \
        + weights
    ops = n * k * (F + 2 * C + 1) + 3 * (V + C) * k
    return 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * ops / FP32_OPS_PER_S


def k10_library(torch, name, a):
    """One PyTorch call computing the same function as the recorded call,
    for ``library_ms``, built outside the timing: K10b's ``gWcat`` as
    ``index_add_`` (float atomics, another order), K10c as a fused
    ``torch.optim.Adam`` step (``fused=True``; another order of the same
    update); None for K10a. Timed here only: the port calls neither."""
    if name == "logreg_backward":
        plan, dl = a[0], a[1]
        flat = plan.gid.reshape(-1)
        src = dl.repeat_interleave(plan.gid.shape[1], dim=0)
        out = torch.zeros((plan.n_vocab, plan.k), device=dl.device)
        return lambda: out.index_add_(0, flat, src)
    if name == "adam_step":
        p = a[0].clone().requires_grad_()
        p.grad = a[1].clone()
        opt = torch.optim.Adam([p], lr=a[4], fused=True)
        opt.step()   # the state's first allocation, outside the timing
        return opt.step
    return None


def k10_bare(k_lin, build, name, a, out):
    """The recorded call's kernel launch through ctypes alone (its table
    prepared once)."""
    import ctypes
    if name == "adam_step":
        p = k_lin.adam_params(out[0], a[1], out[1], out[2], a[4], a[5])
    elif name == "logreg_forward":
        p = k_lin.forward_params(*a, *out)
    else:
        p = k_lin.backward_params(*a, *out)
    lib, stream = build.library(), build.current_stream()
    fn = getattr(lib, f"delphi_{name}")

    def launch():
        return fn(ctypes.addressof(p), stream)
    launch.keep = (a, out)  # the tensors the table points at stay allocated
    launch.table = p
    return launch


def k10_order_chain(a) -> int:
    """K10b's longest chain of dependent adds: the occurrences of its
    most frequent id (every class of an id walks them all)."""
    return int(a[0].lengths.max().item())


def k10_measure(torch, k_lin, build, flush, label, key, name, a):
    """4b for K10: one recorded call (a path's heaviest of its kernel,
    already held bitwise) timed: ms, host, plain, the library's, the
    bound; its kernel_ms deferred."""
    bytes_ms, ops_ms = k10_bound_ms(name, a)
    out = k10_outputs(torch, name, a)
    fn = lambda: k10_call(k_lin, name, a, out)  # noqa: E731
    lib_fn = k10_library(torch, name, a)
    row = {"ms": time_ms(torch, fn, flush), "host_ms": host_ms(torch, fn),
           "plain_ms": time_ms(torch, lambda: k10_call(
               k_lin, name, a, out, plain=True), flush),
           "library_ms": None if lib_fn is None
           else time_ms(torch, lib_fn, flush),
           "bytes_ms": bytes_ms, "ops_ms": ops_ms,
           "bound_ms": max(bytes_ms, ops_ms), "shape": list(key[1:])}
    if name == "logreg_backward":
        row["order_chain"] = k10_order_chain(a)
        row["order_floor_ms"] = row["order_chain"] * ADD_NS[0] / 1e6
    defer_kernel_ms(f"{name} {label}", row, fn,
                    k10_bare(k_lin, build, name, a, out), [name], 1)
    log(f"[{label}-kernels] {name} heaviest call {key[1:]}: "
        f"{fmt({k: v for k, v in row.items() if k != 'shape'})}")
    return row


def logreg_edge_calls(torch, k_lin, shape):
    """One LOGREG_EDGES shape's K10 calls on the card: K10a, K10b on the
    plain forward's dlogits, and K10c (the flat weights, their plain
    gradients, moments from a first plain step, at LOGREG_EDGE_STEPS); as
    (name, inputs) pairs."""
    t = {k: v.cuda() if hasattr(v, "shape") else v
         for k, v in logreg_edge_inputs(shape, sum(shape[:5])).items()}
    plan = k_lin.gather_plan(t["gid"], t["cont"], t["y"], t["sample_w"],
                             t["denom"], t["l2"], t["V"], t["k"])
    fwd = (plan, t["Wcat"], t["Wcont"], t["b"])
    want = k10_outputs(torch, "logreg_forward", fwd)
    k10_call(k_lin, "logreg_forward", fwd, want, plain=True)
    bwd = (plan, want[1], t["Wcat"], t["Wcont"])
    grads = k10_outputs(torch, "logreg_backward", bwd)
    k10_call(k_lin, "logreg_backward", bwd, grads, plain=True)
    flat = torch.cat([t["Wcat"].reshape(-1), t["Wcont"].reshape(-1),
                      t["b"]])
    g = torch.cat([x.reshape(-1) for x in grads])
    mu, nu = torch.zeros_like(flat), torch.zeros_like(flat)
    k_lin.adam_step_plain(flat.clone(), g, mu, nu, 0.2, 1)
    return [("logreg_forward", fwd), ("logreg_backward", bwd)] + [
        ("adam_step", (flat, g, mu, nu, 0.2, s)) for s in LOGREG_EDGE_STEPS]


def logreg_edges(torch, k_lin) -> dict:
    """LOGREG_EDGES (:func:`logreg_edge_calls`) on the card against their
    plain versions on the same card tensors, bit for bit (NaN equal to
    NaN), one launch a call. Fails on a difference. These launches come
    after every traced path and count in no path's launches."""
    t0 = time.perf_counter()
    calls = {name: 0 for name in K10_KERNELS}
    for shape in LOGREG_EDGES:
        cases = logreg_edge_calls(torch, k_lin, shape)
        for name, a in cases:
            before = k_lin.launches[name]
            k10_held(torch, k_lin, name, a, f"4b edge {shape}")
            launched = k_lin.launches[name] - before
            if launched != 1:
                fail(f"4b: {name} launched {launched} times at the edge "
                     f"{shape}")
            calls[name] += 1
        del cases
    return {"shapes": len(LOGREG_EDGES), "calls": calls,
            "seconds": round(time.perf_counter() - t0, 3)}


def parent_k10_library(build, parent):
    """``--logreg-probe --parent DIR``: DIR's ``csrc/linear.cu`` built
    alone with this tree's flags (ptxas's report logged) and loaded. Its
    entry points take this tree's parameter tables (their layouts are
    unchanged)."""
    import ctypes
    out = os.path.join(HERE, "build", "parent_linear")
    os.makedirs(out, exist_ok=True)
    path = os.path.join(out, "libparent_linear.so")
    done = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-Xptxas=-v",
                           "-shared", "-o", path,
                           os.path.join(parent, "delphi_tpu_torch", "csrc",
                                        "linear.cu")],
                          check=True, capture_output=True, text=True)
    for line in (done.stdout + done.stderr).splitlines():
        if "registers" in line or "Compiling entry" in line \
                or "spill" in line:
            log(f"[parent build] {line.strip()}")
    lib = ctypes.CDLL(path)
    for name in K10_KERNELS:
        getattr(lib, "delphi_" + name).restype = ctypes.c_int
        getattr(lib, "delphi_" + name).argtypes = [ctypes.c_void_p,
                                                   ctypes.c_void_p]
    return lib


def k10_probe_row(torch, k_lin, build, flush, label, name, a, floor,
                  parent=None) -> dict:
    """One K10 call of --logreg-probe, held bitwise against its plain
    version on the card, then timed from back-to-back bare launches (L2
    flushed before each burst) and by the profiler (L2 flushed before
    each launch, and back to back) beside its bounds, K10b's order floor
    and ``index_add_``; with ``parent`` (:func:`parent_k10_library`) the
    parent's K10a / K10b on the same inputs too, held bitwise, the device
    times taken parent, change, change, parent."""
    import ctypes
    k10_held(torch, k_lin, name, a, f"--logreg-probe {label}")
    out = k10_outputs(torch, name, a)
    bare = k10_bare(k_lin, build, name, a, out)
    kernel = name   # K10a's records: logreg_forward_kernel or _rows_kernel
    bytes_ms, ops_ms = k10_bound_ms(name, a)
    row = {"label": f"{label} {name}", "ms": bare_ms(torch, bare, flush),
           "bytes_ms": bytes_ms, "ops_ms": ops_ms,
           "bound_ms": max(bytes_ms, ops_ms), **floor}
    if name == "logreg_backward":
        row["order_chain"] = k10_order_chain(a)
        row["order_floor_ms"] = row["order_chain"] * ADD_NS[0] / 1e6
        row["index_add_ms"] = time_ms(torch, k10_library(torch, name, a),
                                      flush)
    launches = [("device", bare)]
    if parent is not None and name != "adam_step":
        pout = k10_outputs(torch, name, a)
        table = bare.table.__class__.from_buffer_copy(bare.table)
        if name == "logreg_forward":
            table.loss, table.dlogits = (x.data_ptr() for x in pout)
        else:
            table.gwcat, table.gwcont, table.gb = (x.data_ptr() for x in pout)
        fn = getattr(parent, "delphi_" + name)
        stream = build.current_stream()
        build.check(fn(ctypes.addressof(table), stream), f"parent {name}")
        want = k10_outputs(torch, name, a)
        k10_call(k_lin, name, a, want, plain=True)
        torch.cuda.synchronize()
        if not all(same_bits(torch, g, w) for g, w in zip(pout, want)):
            fail(f"--logreg-probe: the parent's {name} differs at {label}")

        def parent_launch():
            return fn(ctypes.addressof(table), stream)
        parent_launch.keep = (table, pout)
        row["parent_ms"] = bare_ms(torch, parent_launch, flush)
        launches = [("parent_device", parent_launch), ("device", bare),
                    ("device", bare), ("parent_device", parent_launch)]
    for key, launch in launches:
        for suffix, fl in (("_ms", flush), ("_warm_ms", None)):
            t = device_ms(torch, launch, fl, kernel)
            row.setdefault(key + suffix, []).append(t)
    for key in [k for k in row if k.startswith(("device", "parent_device"))]:
        got = [t for t in row[key] if t is not None]
        row[key] = sum(got) / len(got) if len(got) == len(row[key]) else None
    return row


def logreg_probe(torch, k_lin, build, flush, parent=None) -> list:
    """``python3 chip_smoke.py --logreg-probe``: 4d's first step (the
    zones table's 10,000-row sample, as 4d's warm fit takes it) and every
    LOGREG_EDGES shape, each call held bitwise first, then timed
    (:func:`k10_probe_row`); with ``parent`` the parent's K10a and K10b on
    the same inputs."""
    lib, stream = build.library(), build.current_stream()
    empty = lambda: lib.delphi_launch_floor(stream)  # noqa: E731
    floor = {"launch_floor_ms": bare_ms(torch, empty, flush),
             "launch_floor_device_ms": device_ms(torch, empty, flush,
                                                 "empty_kernel")}
    log(f"[logreg-probe] launch floor (empty kernel): {fmt(floor)}")
    import delphi_tpu_torch as T
    from delphi_tpu_torch.models.encoding import FeatureEncoder
    from delphi_tpu_torch.models.linear import LogisticRegressionModel
    T.set_device("cuda")
    zclean, _ = zones_table(LOGISTIC_ROWS, seed=2)
    sample = zclean.sample(n=10_000, random_state=0)
    design = FeatureEncoder(["district", "parity", "channel", "amount"],
                            ["amount"]).fit_transform_compact(sample)
    calls = {}
    orig = {name: getattr(k_lin, name) for name in K10_KERNELS}

    def recording(name):
        def fn(*args):
            k10_record(calls, name, args)
            return orig[name](*args)
        return fn
    try:
        for name in K10_KERNELS:
            setattr(k_lin, name, recording(name))
        LogisticRegressionModel(n_steps=1).fit(design, sample["zone"])
    finally:
        for name, fn in orig.items():
            setattr(k_lin, name, fn)
    cases = {"4d": list(calls.values())}
    for shape in LOGREG_EDGES:
        cases[f"edge {shape}"] = logreg_edge_calls(torch, k_lin, shape)
    rows = []
    for label, calls_ in cases.items():
        for name, a in calls_:
            row = k10_probe_row(torch, k_lin, build, flush, label, name, a,
                                floor, parent)
            log(f"[logreg-probe] {row['label']}: {fmt(row)}")
            rows.append(row)
    return rows


FRESH_FIT_CHILD = r"""
import sys, time
t_run = time.time()
import pandas as pd
sys.path.insert(0, sys.argv[2])
import torch
from delphi_tpu_torch.models.encoding import FeatureEncoder
from delphi_tpu_torch.models.linear import LogisticRegressionModel
from delphi_tpu_torch.ops.kernels import build
t_imports = time.time()
torch.zeros(1, device="cuda")
torch.cuda.synchronize()
t_cuda = time.time()
build.library()
t_lib = time.time()
sample = pd.read_pickle(sys.argv[1])
design = FeatureEncoder(["district", "parity", "channel", "amount"],
                        ["amount"]).fit_transform_compact(sample)
t0 = time.perf_counter()
model = LogisticRegressionModel().fit(design, sample["zone"])
torch.cuda.synchronize()
fit_s = time.perf_counter() - t0
print(t_run, t_imports, t_cuda, t_lib, time.time(), fit_s,
      model.n_steps_run_, int("torch._dynamo" in sys.modules))
"""


def fresh_fit(sample) -> dict:
    """A fresh process's first ``LogisticRegressionModel().fit`` on
    ``sample`` (the kernel library from phase 2's build): seconds from
    the spawn (the parent's clock) to the fit's end (the child's), split
    into the interpreter's start, the imports (torch and the package),
    the CUDA context, the library's load and the fit (the design's
    encoding between the last two is not counted); the fit's steps; and
    whether ``torch._dynamo`` is loaded after it (the first
    ``torch.optim`` optimizer of a process imports it)."""
    import shutil
    import tempfile
    tmp = tempfile.mkdtemp(prefix="delphi_smoke_4d_")
    try:
        path = os.path.join(tmp, "sample.pkl")
        sample.to_pickle(path)
        start = time.time()
        out = subprocess.run([sys.executable, "-c", FRESH_FIT_CHILD, path,
                              HERE], capture_output=True, text=True,
                             timeout=600)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if out.returncode != 0:
        fail(f"the fresh-process fit failed:\n{out.stderr[-3000:]}")
    *marks, fit_s, steps, dynamo = out.stdout.split()[-8:]
    t_run, t_imports, t_cuda, t_lib, end = (float(m) for m in marks)
    return {"from_start_s": end - start, "interpreter_s": t_run - start,
            "imports_s": t_imports - t_run, "cuda_init_s": t_cuda - t_imports,
            "library_s": t_lib - t_cuda, "fit_s": float(fit_s),
            "steps": int(steps), "dynamo_imported": bool(int(dynamo))}


def fmt(row) -> str:
    return " ".join(f"{k}={v:.5f}" if isinstance(v, float) else f"{k}={v}"
                    for k, v in row.items())


def kernel_cases(torch, k_pair, k_entropy, build, flush):
    """Phase 3: the stand-alone shapes, each K1 result fed to K2. Returns
    (K1 rows, K2 rows) by shape."""
    rng = np.random.default_rng(0)
    cases = [("9x4", 1_000_000, [9, 4]), ("255x255", 1_000_000, [255, 255]),
             ("2047x2047", 1_000_000, [2047, 2047]),
             ("all-NULL 4x4", 1_000_000, [4, 4]), ("n=1 3x5", 1, [3, 5]),
             ("28 pairs of 8 columns", 1_000_000,
              [2, 3, 7, 12, 30, 60, 120, 200]),
             ("153 pairs of 18 columns", 1_000_000,
              [int(v) for v in np.random.default_rng(7).integers(2, 25, 18)])]
    k1_rows, k2_rows = {}, {}
    for label, n, vocab in cases:
        cols = np.stack([rng.integers(0, v, n) for v in vocab]) \
            .astype(np.int32)
        cols[:, rng.random(n) < 0.1] = -1
        if label.startswith("all-NULL"):
            cols[:] = -1
        codes = torch.from_numpy(cols).cuda()
        m = len(vocab)
        pairs = [(0, 1)] if m == 2 else \
            [(i, j) for i in range(m) for j in range(i + 1, m)]
        plan = k_pair.plan_launches(tuple(pairs), tuple(vocab))
        before = k_pair.launches
        counts, off, _ = check_k1(torch, k_pair, codes, pairs, vocab)
        if k_pair.launches - before != len(plan):
            fail(f"K1 {label}: {k_pair.launches - before} launches, planned "
                 f"{len(plan)}")
        if len(pairs) > k_pair.MAX_PAIRS and len(plan) < 2:
            fail(f"K1 {label}: {len(pairs)} pairs did not split")
        check_k2(torch, k_entropy, counts, off, n)
        k1 = measure_k1(torch, k_pair, build, flush, codes, pairs, vocab,
                        label)
        k1["launches_per_call"] = len(plan)
        k2 = measure_k2(torch, k_entropy, build, flush, counts, off, n, label)
        k1_rows[label], k2_rows[label] = k1, k2
        log(f"[kernels] {label} n={n} pairs={len(pairs)}: K1 ok, {fmt(k1)}")
        log(f"[kernels] {label} n={n}: K2 ok, {fmt(k2)}")
        del codes, counts
    return k1_rows, k2_rows


PROBE_LAUNCHES = 400
PROBE_GAP_S = 0.002


def profile_probe(torch, pairs: int = 6) -> dict:
    """``python3 chip_smoke.py --profile-probe``: which ``torch.profiler``
    sessions lose the device records of their first launches. One process:
    a first session, then ``pairs`` pairs of later sessions, a bare
    ``torch.profiler.profile`` and one through the port's
    ``start_profiler`` / ``stop_profiler`` (with the primer). Each session
    holds :data:`PROBE_LAUNCHES` one-kernel launches, each in its own
    ``record_function`` range, waited for and :data:`PROBE_GAP_S` apart;
    per session it prints the launches whose kernel record survived, the
    first lost one, and for the primed ones the primer's surviving
    records and ``complete``."""
    from torch.profiler import ProfilerActivity, profile, record_function
    from delphi_tpu_torch.utils import profiling
    x = torch.ones(1 << 20, device="cuda")
    torch.cuda.synchronize()

    def work():
        for i in range(PROBE_LAUNCHES):
            with record_function(f"probe:{i}"):
                x.mul_(1.0000001)
            torch.cuda.synchronize()
            time.sleep(PROBE_GAP_S)

    def kept(events):
        return sorted(int(e.name.split(":")[1]) for e in events
                      if e.kind == profiling.DEVICE_RANGE
                      and e.name.startswith("probe:"))

    def summary(label, events, raw):
        got = kept(events)
        lost = sorted(set(range(PROBE_LAUNCHES)) - set(got))
        out = {"session": label, "launches": PROBE_LAUNCHES,
               "kernels_kept": sum(1 for e in events
                                   if e.kind == profiling.KERNEL
                                   and "Mul" in e.name),
               "ranges_kept": len(got), "lost": len(lost),
               "first_lost": lost[0] if lost else None}
        if raw is not None:
            out["primer_kept"] = sum(
                1 for e in raw if e.kind == profiling.KERNEL
                and "add" in e.name.lower())
            out["primer_launches"] = profiling.PRIMER_LAUNCHES
            out["complete"] = events.complete
        log(f"[profile-probe] {json.dumps(out)}")
        return out

    def bare(label):
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
        prof.start()
        work()
        torch.cuda.synchronize()
        prof.stop()
        return summary(label, profiling.profiler_events(prof), None)

    def primed(label):
        prof = profiling.start_profiler()
        work()
        events = profiling.stop_profiler(prof)
        return summary(label, events, profiling.profiler_events(prof))

    sessions = [bare("first, bare")]
    for i in range(pairs):
        sessions.append(bare(f"later {i}, bare"))
        sessions.append(primed(f"later {i}, primed"))
    later = sessions[1:]
    return {
        "sessions": sessions,
        "bare_sessions_losing_records": sum(
            1 for s in later if "primer_kept" not in s and s["lost"]),
        "primed_sessions_losing_records": sum(
            1 for s in later if "primer_kept" in s and s["lost"]),
        "primed_sessions_incomplete": sum(
            1 for s in later if s.get("complete") is False)}


def main() -> None:
    t_start = time.perf_counter()
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("CUDA is not available: this smoke test needs an NVIDIA GPU")
    if "--shard-rank" in sys.argv[1:]:
        # a rank process of phase 4m, started by shard_cluster
        shard_rank(int(sys.argv[sys.argv.index("--shard-rank") + 1]))
        return

    # -- 1. device -----------------------------------------------------------
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    log(f"[device] {kind} | nvidia-smi: {smi} | torch {torch.__version__} "
        f"cuda {torch.version.cuda} | devices {torch.cuda.device_count()}")

    if "--profile-probe" in sys.argv[1:]:
        sys.path.insert(0, HERE)
        probe = profile_probe(torch)
        log(f"[total] {time.perf_counter() - t_start:.1f} s")
        print(json.dumps({"profile_probe": probe}))
        print(smi)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind,
            "count": torch.cuda.device_count()}}), flush=True)
        return

    if "--gbdt-probe" in sys.argv[1:]:
        sys.path.insert(0, HERE)
        from delphi_tpu_torch.ops.kernels import build
        from delphi_tpu_torch.ops.kernels import gbdt as k_gbdt
        # -DNAME arguments: a build of the sources with those macros
        build.NVCC_FLAGS = build.NVCC_FLAGS + [
            a for a in sys.argv[1:] if a.startswith("-D")]
        path, compiler_log = build.build(ptxas_verbose=True)
        for line in compiler_log.splitlines():
            if "registers" in line or "Compiling entry" in line \
                    or "spill" in line:
                log(f"[build] {line.strip()}")
        flush = torch.empty(64 * 1024 * 1024, dtype=torch.int32,
                            device="cuda")
        lib, stream = build.library(), build.current_stream()
        chain_out = torch.empty(1, dtype=torch.float32, device="cuda")
        ADD_NS.append(1e6 * time_ms(torch, lambda: lib.delphi_add_chain(
            chain_out.data_ptr(), ADD_CHAIN, 1e-3, stream), flush, reps=5)
            / ADD_CHAIN)
        log(f"[add-latency] {ADD_NS[0]:.4f} ns an add")
        args = sys.argv[1:]
        parent = parent_gbdt_library(build, args[args.index("--parent") + 1]) \
            if "--parent" in args else None
        probe = gbdt_probe(torch, k_gbdt, build, flush, parent)
        log(f"[total] {time.perf_counter() - t_start:.1f} s")
        print(json.dumps({"gbdt_probe": probe, "add_latency_ns": ADD_NS[0],
                          "flags": build.NVCC_FLAGS}))
        print(smi)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind,
            "count": torch.cuda.device_count()}}), flush=True)
        return

    if "--logreg-probe" in sys.argv[1:]:
        sys.path.insert(0, HERE)
        from delphi_tpu_torch.ops.kernels import build
        from delphi_tpu_torch.ops.kernels import linear as k_lin
        path, compiler_log = build.build(ptxas_verbose=True)
        for line in compiler_log.splitlines():
            if "registers" in line or "Compiling entry" in line \
                    or "spill" in line:
                log(f"[build] {line.strip()}")
        flush = torch.empty(64 * 1024 * 1024, dtype=torch.int32,
                            device="cuda")
        lib, stream = build.library(), build.current_stream()
        chain_out = torch.empty(1, dtype=torch.float32, device="cuda")
        ADD_NS.append(1e6 * time_ms(torch, lambda: lib.delphi_add_chain(
            chain_out.data_ptr(), ADD_CHAIN, 1e-3, stream), flush, reps=5)
            / ADD_CHAIN)
        log(f"[add-latency] {ADD_NS[0]:.4f} ns an add")
        args = sys.argv[1:]
        parent = parent_k10_library(build, args[args.index("--parent") + 1]) \
            if "--parent" in args else None
        probe = logreg_probe(torch, k_lin, build, flush, parent)
        log(f"[total] {time.perf_counter() - t_start:.1f} s")
        print(json.dumps({"logreg_probe": probe, "add_latency_ns": ADD_NS[0],
                          "flags": build.NVCC_FLAGS}))
        print(smi)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind,
            "count": torch.cuda.device_count()}}), flush=True)
        return

    for flag, child in (("--gbdt-ab", GBDT_AB_CHILD),
                        ("--domain-ab", DOMAIN_AB_CHILD),
                        ("--logreg-ab", LOGREG_AB_CHILD)):
        if flag in sys.argv[1:]:
            at = sys.argv.index(flag)
            ab = parent_ab(flag[2:], child, sys.argv[at + 1],
                           int(sys.argv[at + 2]))
            log(f"[total] {time.perf_counter() - t_start:.1f} s")
            print(json.dumps({flag[2:].replace("-", "_"): ab["summary"]}))
            print(smi)
            print(json.dumps({"ok": True, "device": {
                "platform": "gpu", "kind": kind,
                "count": torch.cuda.device_count()}}), flush=True)
            return

    sys.path.insert(0, HERE)
    import delphi_tpu_torch as T
    from delphi_tpu_torch.ops.kernels import build
    from delphi_tpu_torch.ops.kernels import domain_scores as k_domain
    from delphi_tpu_torch.ops.kernels import entropy as k_entropy
    from delphi_tpu_torch.ops.kernels import gbdt as k_gbdt
    from delphi_tpu_torch.ops.kernels import linear as k_lin
    from delphi_tpu_torch.ops.kernels import pair_counts as k_pair
    from delphi_tpu_torch.models import gbdt
    from delphi_tpu_torch.models.encoding import FeatureEncoder
    from delphi_tpu_torch.models.linear import LogisticRegressionModel
    from delphi_tpu_torch.utils import (counters, histograms, phase_walls,
                                        train_reports)
    T.set_device("cuda")

    log(f"[elapsed] 1 done at {time.perf_counter() - t_start:.1f} s")
    # -- 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    path, compiler_log = build.build(ptxas_verbose=True)
    log(f"[build] {os.path.relpath(path, HERE)} in "
        f"{time.perf_counter() - t0:.1f} s")
    for line in compiler_log.splitlines():
        if "registers" in line or "Compiling entry" in line \
                or "spill" in line:
            log(f"[build] {line.strip()}")

    flush = torch.empty(64 * 1024 * 1024, dtype=torch.int32, device="cuda")

    log(f"[elapsed] 2 done at {time.perf_counter() - t_start:.1f} s")
    if "--ab" in sys.argv[1:]:
        pairs = int(sys.argv[sys.argv.index("--ab") + 1])
        ab = planes_ab(torch, T, pairs)
        log(f"[total] {time.perf_counter() - t_start:.1f} s")
        print(json.dumps({"ab": ab}))
        print(nvidia_smi_line())
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind,
            "count": torch.cuda.device_count()}}), flush=True)
        return

    # -- 3. kernels at the stand-alone shapes --------------------------------
    lib, stream = build.library(), build.current_stream()
    empty = lambda: lib.delphi_launch_floor(stream)  # noqa: E731
    floor = {"ms": time_ms(torch, empty, flush),
             "host_ms": host_ms(torch, empty),
             "bare_ms": bare_ms(torch, empty, flush)}
    defer_kernel_ms("launch floor", floor, empty, empty, ["empty_kernel"], 1)
    log(f"[launch-floor] empty kernel through ctypes: {fmt(floor)}")
    # one dependent f32 add's latency: a one-thread chain over its length
    chain_out = torch.empty(1, dtype=torch.float32, device="cuda")
    add_chain = lambda: lib.delphi_add_chain(  # noqa: E731
        chain_out.data_ptr(), ADD_CHAIN, 1e-3, stream)
    ADD_NS.append(1e6 * time_ms(torch, add_chain, flush, reps=5) / ADD_CHAIN)
    log(f"[add-latency] {ADD_CHAIN} dependent __fadd_rn in one thread: "
        f"{ADD_NS[0]:.4f} ns an add")
    k1_shapes, k2_shapes = kernel_cases(torch, k_pair, k_entropy, build,
                                        flush)

    log(f"[elapsed] 3 done at {time.perf_counter() - t_start:.1f} s")
    # -- 4. end to end on the card -------------------------------------------
    t0 = time.perf_counter()
    clean, dirty = missing_heavy(E2E_ROWS, seed=0)
    log(f"[e2e] generated {E2E_ROWS} rows in {time.perf_counter() - t0:.1f} s")
    # each driven path's K1, K2 and K5 inputs, by path label, for 4b
    recorded, path_launches = {}, {}
    orig_pc, orig_et = k_pair.pair_counts, k_entropy.entropy_terms
    orig_ds, orig_wl = k_domain.domain_scores, k_domain.weak_label
    orig_gbdt = {name: getattr(k_gbdt, name)
                 for name in ("hist", "split", "route", "predict")}
    orig_k10 = {name: getattr(k_lin, name) for name in K10_KERNELS}
    from delphi_tpu_torch.ops import domain as t_domain
    orig_bucket = t_domain._launch_bucket_once

    from delphi_tpu_torch.parallel import resilience as rz

    def traced(label, fn, faults_ok=False):
        """Runs ``fn()`` as one main path: every count zeroed just before
        and read just after, its K1 and K2 inputs recorded under
        ``label``. Fails on any ``resilience.faults.*`` or
        ``resilience.degrade.*`` count unless ``faults_ok``; logs the
        guarded entries per site. Returns (result, wall s, launches,
        counters, phase walls, peak device MiB above what was held, MiB
        held)."""
        rec = recorded[label] = {"pair_counts": [], "entropy_terms": [],
                                 "domain_scores": []}

        # only calls that launch a kernel are recorded: with no pair, no
        # segment or no cell a wrapper returns its empty result unlaunched
        # (the gauntlet's runs prune every pair of some scenarios, 4t)
        def rec_pair_counts(codes, pairs, vocab):
            if len(pairs) and codes.shape[1]:
                rec["pair_counts"].append((codes, list(pairs), list(vocab)))
            return orig_pc(codes, pairs, vocab)

        def rec_entropy_terms(counts, offsets, n_rows):
            if len(offsets) > 1:
                rec["entropy_terms"].append(
                    (counts, np.asarray(offsets, dtype=np.int64), n_rows))
            return orig_et(counts, offsets, n_rows)

        # the real pieces of the bucket launch in flight on this thread
        # (served requests launch side by side, 4r), for K5's bound, and
        # their groups, for 4m(d)'s split by owner
        inflight = threading.local()
        rec["k5_groups"] = []

        def rec_launch_bucket(batch, *rest):
            inflight.extents = [(len(p.rows), len(p.hs),
                                 tuple(map(int, p.vcs))) for _, _, p in batch]
            inflight.groups = [gi for gi, _, _ in batch]
            return orig_bucket(batch, *rest)

        # each K5 call as (mode, operands, beta, n_rows, extents)
        def rec_domain_scores(ops):
            if ops.layout.cells:
                rec["domain_scores"].append(
                    ("int", ops, None, None,
                     list(getattr(inflight, "extents", []))))
                rec["k5_groups"].append(
                    list(getattr(inflight, "groups", [])))
            return orig_ds(ops)

        def rec_weak_label(ops, beta, n_rows):
            if ops.layout.cells:
                rec["domain_scores"].append(
                    ("weak", ops, beta, n_rows,
                     list(getattr(inflight, "extents", []))))
                rec["k5_groups"].append(
                    list(getattr(inflight, "groups", [])))
            return orig_wl(ops, beta, n_rows)

        # the first K3 / K4 call of each structure, held after the run
        gbdt_calls = {}

        def rec_gbdt(name):
            fn_ = orig_gbdt[name]

            def call(*args, **kwargs):
                gbdt_record(gbdt_calls, name, fn_, args, kwargs)
                return fn_(*args, **kwargs)
            return call

        # the first K10 call of each structure, held after the run (card
        # tensors only: a CPU fit takes the plain versions)
        k10_calls = {}

        def rec_k10(name):
            fn_ = orig_k10[name]

            def call(*args):
                if args[1].is_cuda:
                    k10_record(k10_calls, name, args)
                return fn_(*args)
            return call

        phase_walls.clear()
        counters.clear()
        histograms.clear()
        train_reports.clear()
        rz.entries.clear()
        k_pair.reset_launches()
        k_entropy.reset_launches()
        k_domain.reset_launches()
        k_gbdt.reset_launches()
        k_lin.reset_launches()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        k_pair.pair_counts = rec_pair_counts
        k_entropy.entropy_terms = rec_entropy_terms
        k_domain.domain_scores = rec_domain_scores
        k_domain.weak_label = rec_weak_label
        t_domain._launch_bucket_once = rec_launch_bucket
        for name in orig_gbdt:
            setattr(k_gbdt, name, rec_gbdt(name))
        for name in orig_k10:
            setattr(k_lin, name, rec_k10(name))
        try:
            t0 = time.perf_counter()
            res = fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            k_pair.pair_counts, k_entropy.entropy_terms = orig_pc, orig_et
            k_domain.domain_scores, k_domain.weak_label = orig_ds, orig_wl
            t_domain._launch_bucket_once = orig_bucket
            for name, fn_ in orig_gbdt.items():
                setattr(k_gbdt, name, fn_)
            for name, fn_ in orig_k10.items():
                setattr(k_lin, name, fn_)
        gbdt_launches = dict(k_gbdt.launches)
        k10_launches = dict(k_lin.launches)
        launches = {"pair_counts": k_pair.launches,
                    "entropy_terms": k_entropy.launches}
        # K5 launches only where weak-label demotion scores cells (every
        # path but the dependency graph's): checked per path below, in
        # the integer mode on the paths with a ledger (K5_INT_PATHS) and in
        # the weak-label mode on every other
        path_launches[label] = {**launches,
                                "domain_scores": k_domain.launches,
                                **{f"k5_{m}": n for m, n in
                                   k_domain.mode_launches.items()},
                                **gbdt_launches, **k10_launches}
        log(f"[{label}] K3 / K4 launches: {json.dumps(gbdt_launches)}")
        if label in GBDT_PATHS and min(gbdt_launches.values()) < 1:
            fail(f"{label}: a GBDT kernel was not launched by the run: "
                 f"{gbdt_launches}")
        # every structure of K3 / K4 call this path made, bitwise; its
        # heaviest call of each kernel kept for 4b's times
        rec["gbdt_held"], rec["gbdt"] = gbdt_hold(torch, k_gbdt, gbdt_calls,
                                                  label)
        for kernel, n in gbdt_launches.items():
            if n and not rec["gbdt_held"][kernel]["calls_checked"]:
                fail(f"{label}: {kernel} launched {n} times, no call "
                     "recorded")
        if any(n for n in gbdt_launches.values()):
            log(f"[{label}] K3 / K4 calls of distinct structure, each "
                f"bitwise equal to its plain version: "
                f"{json.dumps(rec['gbdt_held'])}")
        # every structure of K10 call this path made, bitwise; its
        # heaviest call of each kernel kept for 4b's times
        rec["k10_held"], rec["k10"] = k10_hold(torch, k_lin, k10_calls,
                                               label)
        for kernel, n in k10_launches.items():
            if n and not rec["k10_held"][kernel]["calls_checked"]:
                fail(f"{label}: {kernel} launched {n} times, no call "
                     "recorded")
        if any(n for n in k10_launches.values()):
            log(f"[{label}] K10 launches {json.dumps(k10_launches)}; calls "
                f"of distinct structure, each bitwise equal to its plain "
                f"version: {json.dumps(rec['k10_held'])}")
        int_path = label in K5_INT_PATHS
        if k_domain.mode_launches["weak" if int_path else "int"]:
            fail(f"{label}: K5 launched {k_domain.mode_launches}, the "
                 f"{'integer' if int_path else 'weak-label'} mode only "
                 "expected")
        if not faults_ok and fault_counts(counters):
            fail(f"{label}: an unfaulted run counted faults or "
                 f"degradations: {fault_counts(counters)}")
        log(f"[{label}] guarded entries per site: "
            f"{json.dumps(dict(sorted(rz.entries.items())))}")
        walls = {k: round(v, 3) for k, v in phase_walls.items()}
        peak = (torch.cuda.max_memory_allocated() - held) / 2**20
        return res, wall, launches, dict(counters), walls, peak, held / 2**20

    def drive(label, df, clean_df, cells, batched=False):
        """One main path of the NULL repair (``traced``); phase walls,
        training summary, accuracy, memory."""
        res, wall, launches, counts, walls, peak, held = traced(
            label, lambda: repair(T, df, batched=batched))
        summary = training_summary(train_reports)
        models = {r["target"]: r["model"] for r in train_reports}
        n_err = int(df[cells].isna().to_numpy().sum())
        if list(res.columns) != ["tid", "attribute", "current_value",
                                 "repaired"]:
            fail(f"{label}: unexpected result columns {list(res.columns)}")
        acc = repair_accuracy(clean_df, res)
        log(f"[{label}] rows={len(df)} wall_s={wall:.3f} error_cells={n_err} "
            f"repairs={len(res)} accuracy={acc:.6f} launches={launches} "
            f"counters={json.dumps(counts)}")
        log(f"[{label}] phase walls (s): {json.dumps(walls)}; peak device "
            f"memory {peak:.1f} MiB above the {held:.1f} MiB held before "
            "the run")
        log(f"[{label}] training: CV search {summary['cv_search_s']:.3f} s, "
            f"final fit {summary['final_fit_s']:.3f} s")
        for target, t in summary["targets"].items():
            log(f"[{label}] target {target}: {json.dumps(t, default=str)}")
        if len(res) != n_err or res["repaired"].isna().any():
            fail(f"{label}: expected {n_err} non-NULL repairs, got {len(res)}")
        if acc < MIN_ACCURACY:
            fail(f"{label}: repair accuracy {acc} below {MIN_ACCURACY}")
        for name, count in launches.items():
            if count < 1:
                fail(f"{label}: kernel {name} was not launched by the run")
        return res, launches, counts, models, wall

    # the main path: sequential training at default options
    cells = ["tier", "band", "grade"]
    out, launches, _, _, wall = drive("e2e", dirty, clean, cells)
    e2e_wall = wall
    # the pipeline's numbers of this (pipelined) run, for 4l(a)
    e2e_run = pipeline_summary(
        wall, dict(counters),
        {k: round(v, 3) for k, v in phase_walls.items()}, dict(histograms))
    if path_launches["e2e"]["domain_scores"] < 1:
        fail("e2e: kernel domain_scores (K5) was not launched by the run")
    domain_summary("e2e", dict(counters), dict(phase_walls))
    log(f"[e2e] wall {wall:.3f} s behind the guarded seam; "
        f"{PRE_SEAM_E2E_WALL_S} s on the same table before the seam "
        "existed (another host: the seam's overhead is reported, not "
        "gated)")

    log(f"[elapsed] 4 done at {time.perf_counter() - t_start:.1f} s")
    # -- 4n. the run report on the card (again late, after 5) ----------------
    report_res = run_report_plane(torch, T, traced, dirty, out, e2e_wall)

    log(f"[elapsed] 4n done at {time.perf_counter() - t_start:.1f} s")
    # -- 4c. batched training on the same table ------------------------------
    batched, _, counts, _, _ = drive("batched", dirty, clean, cells,
                                     batched=True)
    if not batched.equals(out):
        fail("batched training's repair frame differs from sequential's")
    for name in ("gbdt.cv_multi_target_launches", "gbdt.fit_batch_launches"):
        if counts.get(name, 0) < 1:
            fail(f"batched training made no {name}")
    if counts.get("train.batched_fallbacks", 0):
        fail("batched training fell back to per-target fits")
    log("[batched] frame identical to the sequential run's")

    log(f"[elapsed] 4c done at {time.perf_counter() - t_start:.1f} s")
    # -- 4d. the logistic head -----------------------------------------------
    zclean, zdirty = zones_table(LOGISTIC_ROWS, seed=2)
    _, _, _, zmodels, _ = drive(K10_MAIN_PATH, zdirty, zclean, ["zone"])
    zmodel = zmodels.get("zone")
    if not isinstance(zmodel, LogisticRegressionModel):
        fail(f"zone trained {type(zmodel).__name__}, not the logistic head")
    # the gather route: K10a, K10b and K10c at least once an applied step
    k10_e2e = {n: path_launches[K10_MAIN_PATH][n] for n in K10_KERNELS}
    zsteps = zmodel.n_steps_run_
    if zmodel._compact is None or min(k10_e2e.values()) < zsteps:
        fail(f"logistic: {zsteps} steps of the gather route launched "
             f"{k10_e2e}, not K10a, K10b and K10c once a step")
    zfit_s = zmodel.train_report_["fit_seconds"]
    logistic_run = {"steps": zsteps, "launches": k10_e2e,
                    "fit_s": zfit_s, "ms_per_step": 1e3 * zfit_s / zsteps,
                    "training_span_s": phase_walls["repair model training"]}
    log(f"[logistic] gather fit: {zsteps} steps, K10 launches "
        f"{json.dumps(k10_e2e)}, fit {zfit_s:.3f} s, "
        f"{logistic_run['ms_per_step']:.4f} ms a step, training span "
        f"{logistic_run['training_span_s']:.3f} s")
    # the same fit warm, a fresh process's first fit, and, on the same
    # host, what a fresh process pays for its first torch.optim.Adam
    sample = zclean.sample(n=10_000, random_state=0)
    design = FeatureEncoder(["district", "parity", "channel", "amount"],
                            ["amount"]).fit_transform_compact(sample)
    torch.cuda.synchronize()
    k_lin.reset_launches()
    t0 = time.perf_counter()
    warm = LogisticRegressionModel().fit(design, sample["zone"])
    warm_s = time.perf_counter() - t0
    warm_launches = dict(k_lin.launches)
    fresh = fresh_fit(sample)
    if fresh["dynamo_imported"]:
        fail("a fresh process's first logistic fit imported torch._dynamo")
    first_adam = subprocess.run(
        [sys.executable, "-c", "import time, torch; t = time.perf_counter(); "
         "torch.optim.Adam([torch.zeros(1, requires_grad=True)]); "
         "print(time.perf_counter() - t)"],
        capture_output=True, text=True, timeout=300, check=True)
    logistic_run.update({
        "warm_fit_s": warm_s, "warm_steps": warm.n_steps_run_,
        "warm_ms_per_step": 1e3 * warm_s / warm.n_steps_run_,
        "warm_launches": warm_launches, "fresh_process": fresh,
        "first_torch_optim_adam_s": float(first_adam.stdout.strip())})
    log(f"[logistic] warm fit, 10,000 rows: {warm_s:.3f} s, "
        f"{warm.n_steps_run_} steps, "
        f"{logistic_run['warm_ms_per_step']:.4f} ms a step, K10 launches "
        f"{json.dumps(warm_launches)}; a fresh process's first fit: "
        f"{json.dumps(fresh)}; first torch.optim.Adam of a fresh process: "
        f"{logistic_run['first_torch_optim_adam_s']:.3f} s")

    log(f"[elapsed] 4d done at {time.perf_counter() - t_start:.1f} s")
    # -- 4e. tree-builder cost per boosting round ----------------------------
    rounds = {}
    for depth in (3, 5):
        ms, kernels, hand = boost_round_profile(torch, gbdt, k_gbdt, depth)
        rounds[f"depth{depth}"] = {"ms_per_round": ms,
                                   "kernels_per_round": kernels,
                                   "gbdt_launches_per_round": hand}
        if hand["gbdt_hist"] != depth + 1 or hand["gbdt_split"] != depth \
                or hand["gbdt_route"] != depth:
            fail(f"4e: a depth-{depth} round launched {hand}, not one K3a "
                 "per level and the leaf sums, one K3b and one K3c per "
                 "level")
    log(f"[train-profile] one CV step of a 6-class target (3 folds x 8 "
        f"class trees, 10,000 rows, 4 features): {json.dumps(rounds)}")

    log(f"[elapsed] 4e done at {time.perf_counter() - t_start:.1f} s")
    # -- 4f. the constraints path ---------------------------------------------
    constraints_path(torch, T, traced)
    if path_launches["constraints"]["domain_scores"] < 1:
        fail("constraints: kernel domain_scores (K5) was not launched")

    log(f"[elapsed] 4f done at {time.perf_counter() - t_start:.1f} s")
    # -- 4g. rule repairs and the PMF modes -----------------------------------
    rules_and_pmf(torch, T, traced)

    log(f"[elapsed] 4g done at {time.perf_counter() - t_start:.1f} s")
    # -- 4h. delphi.misc and the batch CLI ------------------------------------
    misc_and_cli(torch, T, traced)

    log(f"[elapsed] 4h done at {time.perf_counter() - t_start:.1f} s")
    # -- 4i. the provenance ledger and the escalation tier -------------------
    esc = ledger_and_escalation(torch, T, traced)

    log(f"[elapsed] 4i done at {time.perf_counter() - t_start:.1f} s")
    if path_launches["escalation"]["k5_int"] < 1:
        fail("escalation: K5's integer mode was not launched (a ledger run)")

    # -- 4j. incremental and streaming repair --------------------------------
    incremental_and_stream(torch, T, traced)

    log(f"[elapsed] 4j done at {time.perf_counter() - t_start:.1f} s")
    # -- 4k. the resilience plane --------------------------------------------
    resilience_plane(torch, T, traced, dirty, out)

    log(f"[elapsed] 4k done at {time.perf_counter() - t_start:.1f} s")
    # -- 4l. the pipeline, the bucketed domain route, plans, build cache -----
    planes_res = planes(torch, T, traced, dirty, out, e2e_run)

    log(f"[elapsed] 4l done at {time.perf_counter() - t_start:.1f} s")
    # -- 4m. the row-shard plane: two ranks on the one card ------------------
    shard = shard_plane(torch, T, build, flush, k_pair, k_entropy, k_domain,
                        recorded, recorded["e2e"]["k5_groups"], out,
                        planes_res["plans_frame"])

    log(f"[elapsed] 4m done at {time.perf_counter() - t_start:.1f} s")
    # -- 4o. the device mesh: two ranks on the one card ----------------------
    mesh = mesh_plane(torch, T, build, flush, k_pair, k_entropy, k_domain,
                      out, planes_res["plans_frame"])

    log(f"[elapsed] 4o done at {time.perf_counter() - t_start:.1f} s")
    # -- 4p. process-local tables: two ranks on the one card -----------------
    pl = process_local_plane(torch, T, build, flush, k_pair, k_entropy,
                             dirty)

    log(f"[elapsed] 4p done at {time.perf_counter() - t_start:.1f} s")
    # -- 4q. the live plane --------------------------------------------------
    live_res = live_plane(torch, T, dirty, out, e2e_wall)

    log(f"[elapsed] 4q done at {time.perf_counter() - t_start:.1f} s")
    # -- 4r. the serving plane -----------------------------------------------
    served = serving_plane(torch, T, traced, path_launches)

    log(f"[elapsed] 4r done at {time.perf_counter() - t_start:.1f} s")
    # -- 4s. the fleet: two worker processes on the one card -----------------
    fleet_res = fleet_plane(torch, T, build, served)

    log(f"[elapsed] 4s done at {time.perf_counter() - t_start:.1f} s")
    # -- 4t. the gauntlet ----------------------------------------------------
    gauntlet_res = gauntlet_plane(torch, T, traced, path_launches)

    log(f"[elapsed] 4t done at {time.perf_counter() - t_start:.1f} s")
    # -- 4u. sustained open-loop load against port workers -------------------
    load_res = load_plane(build)

    log(f"[elapsed] 4u done at {time.perf_counter() - t_start:.1f} s")
    # -- 4b. each kernel on the inputs each path gave it ---------------------
    def main_path(rows):
        keys = ("ms", "host_ms", "kernel_ms", "plain_ms", "library_ms",
                "bound_ms")
        total = {k: (None if any(r[k] is None for r in rows)
                     else sum(r[k] for r in rows)) for k in keys}
        total["calls"] = len(rows)
        return total

    # per path: K1 rows, K2 rows, K1 max |err|, K2 max |err|; K1 bitwise and
    # K2 within 1e-12 relative of the plain versions on that path's inputs
    # (K5 bitwise too, in the mode the path launched)
    path_rows = {}
    k5_host_route = {}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for path, rec in recorded.items():
        k1_err, k1_rows = 0, []
        for codes, pairs, vocab in rec["pair_counts"]:
            _, _, err = check_k1(torch, k_pair, codes, pairs, vocab)
            k1_err = max(k1_err, err)
            k1_rows.append(measure_k1(torch, k_pair, build, flush, codes,
                                      pairs, vocab,
                                      f"{path} call {len(k1_rows)}"))
            log(f"[{path}-kernels] K1 pairs={len(pairs)} "
                f"n={codes.shape[1]} vocab={vocab}: {fmt(k1_rows[-1])}")
        k2_err, k2_rows = 0.0, []
        for counts, offsets, n_rows in rec["entropy_terms"]:
            k2_err = max(k2_err, check_k2(torch, k_entropy, counts, offsets,
                                          n_rows))
            k2_rows.append(measure_k2(torch, k_entropy, build, flush, counts,
                                      offsets, n_rows,
                                      f"{path} call {len(k2_rows)}"))
            log(f"[{path}-kernels] K2 segments={len(offsets) - 1} "
                f"counts={int(offsets[-1] - offsets[0])}: {fmt(k2_rows[-1])}")
        k5_err, k5_rows = 0, []
        for call in rec["domain_scores"]:
            mode, ops, _, _, extents = call
            if not extents:
                fail(f"{path}: K5 launched outside a bucket launch")
            k5_err = max(k5_err, check_k5(torch, k_domain, call))
            if path == "e2e" and mode == "weak":
                k5_host_route[f"e2e call {len(k5_rows)}"] = \
                    check_k5_host_route(torch, k_domain, call)
            k5_rows.append(measure_k5(torch, k_domain, build, flush, call,
                                      f"{path} call {len(k5_rows)}"))
            lay = ops.layout
            log(f"[{path}-kernels] K5 {mode} mode (b, k, vc_pad, va, "
                f"cells)={(lay.b, lay.k, lay.vc_pad, lay.va, lay.cells)}, "
                f"real (cells, v_a) per piece {list(lay.extents)}, launch "
                f"{k_domain.launch_shape(lay, mode == 'weak', sms)}: "
                f"{fmt(k5_rows[-1])}")
        path_rows[path] = (k1_rows, k2_rows, k1_err, k2_err, k5_rows, k5_err)
        log(f"[{path}-kernels] K1 ({len(k1_rows)} calls) and K5 "
            f"({len(k5_rows)} calls) bitwise equal and K2 ({len(k2_rows)} "
            f"calls) within 1e-12 relative of their plain versions on this "
            f"path's inputs: max |err| {k1_err}, {k5_err}, {k2_err}")
    if not k5_host_route:
        fail("e2e: no weak-label K5 launch to hold against the host route")
    log(f"[e2e-kernels] K5's weak-label mode equals the host numpy route "
        f"(integer mode, _combine_scores, the host pick) on the main "
        f"path's launches; cells with a domain per launch: "
        f"{json.dumps(k5_host_route)}")
    k5_branches = k5_table_branches(torch, k_domain)
    log(f"[kernels] K5's shared-memory and __ldg table branches, both "
        f"modes, bitwise equal to the plain version: "
        f"{json.dumps(k5_branches)}")
    edges = gbdt_edges(torch, k_gbdt)
    log(f"[kernels] K3a and K3b at their edges bitwise equal to their plain "
        f"versions (NaN equal to NaN): {json.dumps(edges)}")
    rp_edges = gbdt_route_edges(torch, k_gbdt)
    log(f"[kernels] K3c and K4 at their edges bitwise equal to their plain "
        f"versions (NaN equal to NaN), one launch a call: "
        f"{json.dumps(rp_edges)}")
    lr_edges = logreg_edges(torch, k_lin)
    log(f"[kernels] LOGREG_EDGES: K10a, K10b and K10c at their edges "
        f"bitwise equal to their plain versions (NaN equal to NaN), one "
        f"launch a call: {json.dumps(lr_edges)}")
    # K3 and K4: each traced path's heaviest call of each kernel timed
    gbdt_rows = {path: {kernel: gbdt_measure(torch, k_gbdt, build, flush,
                                             path, *call)
                        for kernel, call in rec["gbdt"].items()}
                 for path, rec in recorded.items()}
    for name in GBDT_KERNELS:
        if name not in gbdt_rows[GBDT_MAIN_PATH]:
            fail(f"{GBDT_MAIN_PATH}: no {name} call recorded")
    # K10: each traced path's heaviest call of each kernel timed
    k10_rows = {path: {kernel: k10_measure(torch, k_lin, build, flush, path,
                                           *call)
                       for kernel, call in rec["k10"].items()}
                for path, rec in recorded.items()}
    for name in K10_KERNELS:
        if name not in k10_rows[K10_MAIN_PATH]:
            fail(f"{K10_MAIN_PATH}: no {name} call recorded")

    # neither wrapper may wait for the card at any path's shapes
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for rec in recorded.values():
            for codes, pairs, vocab in rec["pair_counts"]:
                k_pair.pair_counts(codes, pairs, vocab)
            for counts, offsets, n_rows in rec["entropy_terms"]:
                k_entropy.entropy_terms(counts, offsets, n_rows)
            for call in rec["domain_scores"]:
                k5_run(k_domain, call)
            for _, name, a in rec["gbdt"].values():
                gbdt_run(k_gbdt, name, a)
            for _, name, a in rec["k10"].values():
                k10_call(k_lin, name, a, k10_outputs(torch, name, a))
    except RuntimeError as exc:
        fail(f"a kernel wrapper synchronised with the card: {exc}")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    log("[sync] K1, K2, K3, K4, K5 and K10 wrappers ran under "
        "set_sync_debug_mode('error') "
        f"at the shapes of paths {list(recorded)} without synchronising")

    log(f"[elapsed] 4b done at {time.perf_counter() - t_start:.1f} s")
    # -- 5. CPU (plain versions) vs card (kernels) ---------------------------
    def both(df):
        """(CPU frame, card frame, CPU models, card models, CPU logistic
        gaps) of one default-option repair."""
        frames, models, gaps = [], [], None
        for dev in ("cpu", "cuda"):
            T.set_device(dev)
            train_reports.clear()
            g, restore = logistic_gaps(T)
            before = k_pair.launches, k_entropy.launches
            try:
                frames.append(repair(T, df))
            finally:
                restore()
            if dev == "cuda" and (k_pair.launches,
                                  k_entropy.launches) <= before:
                fail("a 20k-row card run did not launch the kernels")
            models.append({r["target"]: type(r["model"]).__name__
                           for r in train_reports})
            gaps = g if dev == "cpu" else gaps
        return frames[0], frames[1], models[0], models[1], gaps

    t0 = time.perf_counter()
    _, small = missing_heavy(CHECK_ROWS, seed=1)
    on_cpu, on_gpu, m_cpu, m_gpu, _ = both(small)
    if not on_cpu.equals(on_gpu):
        diff = on_cpu.merge(on_gpu, on=["tid", "attribute"], how="outer",
                            suffixes=("_cpu", "_gpu"))
        diff = diff[diff["repaired_cpu"] != diff["repaired_gpu"]]
        fail(f"20k-row repair frames differ between CPU and card:\n"
             f"{diff.head(20)}")
    log(f"[cross-check] {CHECK_ROWS} rows, default options: CPU and card "
        f"GBDT repair frames identical ({len(on_gpu)} repairs; models "
        f"{m_gpu})")

    _, zsmall = zones_table(CHECK_ROWS, seed=3)
    z_cpu, z_gpu, zm_cpu, zm_gpu, gaps = both(zsmall)
    if len(gaps) != 1 or len(gaps[0]) != len(z_cpu) or not z_cpu[
            ["tid", "attribute"]].equals(z_gpu[["tid", "attribute"]]):
        fail("logistic cross-check: the CPU and card repair different cells")
    near = gaps[0] < NEAR_TIE
    differ = z_cpu["repaired"].to_numpy() != z_gpu["repaired"].to_numpy()
    if (differ & ~near).any():
        fail(f"logistic head: {int((differ & ~near).sum())} repairs with a "
             f"top-two gap over {NEAR_TIE} differ between CPU and card")
    for on_card, on_cpu_ in ((zm_gpu, zm_cpu), (m_gpu, m_cpu)):
        for target, model_kind in on_card.items():
            if model_kind == "PoorModel" and on_cpu_.get(target) != "PoorModel":
                fail(f"{target} ended as PoorModel on the card only")
    log(f"[cross-check] {CHECK_ROWS} rows, logistic head: {len(z_gpu)} "
        f"repairs, {int(near.sum())} under a top-two gap of {NEAR_TIE} "
        f"({int((differ & near).sum())} of them differ), every other repair "
        f"identical; models CPU {zm_cpu} card {zm_gpu} "
        f"({time.perf_counter() - t0:.1f} s)")

    log(f"[elapsed] 5 done at {time.perf_counter() - t_start:.1f} s")
    # -- 4n, late: the profiled run again at the end of this long process ----
    report_res["late"] = late_profile_check(torch, T, dirty, out)
    log(f"[elapsed] 4n (late) done at {time.perf_counter() - t_start:.1f} s")
    # -- 6. kernel device times from torch.profiler, last --------------------
    bare_rows = finish_kernel_ms(torch, flush)
    floor["ms_after_profiler"] = time_ms(torch, empty, flush)
    floor["host_ms_after_profiler"] = host_ms(torch, empty)
    log(f"[timing] every kernel_ms from complete torch.profiler records: "
        f"{all(PROFILER_SEES_KERNELS)}; launch floor {fmt(floor)}")
    paths = {"pair_counts": [], "entropy_terms": [], "k5_weak": [],
             "k5_int": []}
    for path, (k1_rows, k2_rows, k1_err, k2_err, k5_rows,
               k5_err) in path_rows.items():
        k5_name = "k5_int" if path in K5_INT_PATHS else "k5_weak"
        for name, rows, err in (("pair_counts", k1_rows, k1_err),
                                ("entropy_terms", k2_rows, k2_err),
                                (k5_name, k5_rows, k5_err)):
            if name == k5_name and not rows:
                continue
            total = main_path(rows)
            log(f"[{path}-kernels] {name}: {fmt(total)}")
            paths[name].append({"path": path,
                                "launches": path_launches[path][name],
                                "max_abs_err": err, **total})
    k1_rows, k2_rows, _, _, k5_rows, _ = path_rows["e2e"]
    k1, k2, k5 = main_path(k1_rows), main_path(k2_rows), main_path(k5_rows)
    # the integer mode's main path: the escalation run (a ledger)
    k5i = main_path(path_rows["escalation"][4])
    k1_err = max(p["max_abs_err"] for p in paths["pair_counts"])
    k2_err = max(p["max_abs_err"] for p in paths["entropy_terms"])
    k5_err = max(p["max_abs_err"] for p in paths["k5_weak"])
    k5i_err = max(p["max_abs_err"] for p in paths["k5_int"])
    k5_by = "bytes" if sum(r["bytes_ms"] for r in k5_rows) >= sum(
        r["ops_ms"] for r in k5_rows) else "operations"
    k2_bytes = sum(r["bytes_ms"] for r in k2_rows)
    k2_ops = sum(r["ops_ms"] for r in k2_rows)

    def shapes(rows):
        return [{"shape": k, **{f: v for f, v in r.items()
                                if f not in ("bytes_ms", "ops_ms")}}
                for k, r in rows.items()]

    kernels = [
        {"name": "pair_counts", "route": "cuda",
         "source": "delphi_tpu_torch/csrc/pair_counts.cu",
         "replaces": "delphi_tpu/ops/pallas_kernels.py:79",
         "tpu_source": "delphi_tpu/ops/pallas_kernels.py:_pair_count_kernel",
         "launches": launches["pair_counts"], "max_abs_err": k1_err,
         "ms": k1["ms"], "kernel_ms": k1["kernel_ms"],
         "launch_floor_ms": floor["ms"], "plain_ms": k1["plain_ms"],
         "bound_ms": k1["bound_ms"], "bound_by": "bytes",
         "library_ms": k1["library_ms"], "shapes": shapes(k1_shapes),
         "paths": paths["pair_counts"], "ok": True},
        {"name": "entropy_terms", "route": "cuda",
         "source": "delphi_tpu_torch/csrc/entropy.cu",
         "replaces": "delphi_tpu/ops/pallas_kernels.py:186",
         "tpu_source": "delphi_tpu/ops/pallas_kernels.py:_entropy_kernel",
         "launches": launches["entropy_terms"], "max_abs_err": k2_err,
         "ms": k2["ms"], "kernel_ms": k2["kernel_ms"],
         "launch_floor_ms": floor["ms"], "plain_ms": k2["plain_ms"],
         "bound_ms": max(k2_bytes, k2_ops),
         "bound_by": "bytes" if k2_bytes >= k2_ops else "operations",
         "library_ms": None, "shapes": shapes(k2_shapes),
         "paths": paths["entropy_terms"], "ok": True},
        {"name": "domain_scores_weak", "route": "cuda",
         "source": "delphi_tpu_torch/csrc/domain_scores.cu",
         "replaces": "delphi_tpu/ops/domain.py:774",
         "tpu_source": "delphi_tpu/ops/domain.py:_jit_bucket_kernel "
                       "(fused mode :774-793; jitted XLA, not Pallas)",
         "mode": "weak-label", "main_path": "e2e",
         "launches": path_launches["e2e"]["k5_weak"],
         "max_abs_err": k5_err, "ms": k5["ms"], "host_ms": k5["host_ms"],
         "kernel_ms": k5["kernel_ms"], "launch_floor_ms": floor["ms"],
         "plain_ms": k5["plain_ms"], "bound_ms": k5["bound_ms"],
         "bound_by": k5_by, "library_ms": None,
         "host_route_cells": k5_host_route, "table_branches": k5_branches,
         "paths": paths["k5_weak"], "ok": True},
        {"name": "domain_scores_int", "route": "cuda",
         "source": "delphi_tpu_torch/csrc/domain_scores.cu",
         "replaces": "delphi_tpu/ops/domain.py:764",
         "tpu_source": "delphi_tpu/ops/domain.py:_jit_bucket_kernel "
                       "(integer mode :764-772 of _int_score_body :432; "
                       "jitted XLA, not Pallas)",
         "mode": "integer", "main_path": "escalation",
         "launches": path_launches["escalation"]["k5_int"],
         "max_abs_err": k5i_err, "ms": k5i["ms"], "host_ms": k5i["host_ms"],
         "kernel_ms": k5i["kernel_ms"], "launch_floor_ms": floor["ms"],
         "plain_ms": k5i["plain_ms"], "bound_ms": k5i["bound_ms"],
         "bound_by": "bytes", "library_ms": None,
         "paths": paths["k5_int"], "ok": True},
    ]
    # 4m: each rank's K1, K2 (its H(y) launch) and K5 inputs as paths of
    # those kernels, and K2's owned-segment launches as an entry of their
    # own (rank 0's numbers; both ranks under "paths")
    owned_paths = []
    for r in range(SHARD_WORLD):
        rows_r, rank = shard["rows"][r], shard[f"rank{r}"]
        for entry in kernels:
            name = entry["name"]
            if rows_r.get(name):
                entry["paths"].append({
                    "path": f"shard r{r} (1M / {SHARD_WORLD})",
                    "launches": rank["launches"][name],
                    "max_abs_err": rows_r["errs"][name],
                    **main_path(rows_r[name])})
        owned_paths.append({
            "path": f"shard r{r} (1M / {SHARD_WORLD})",
            "launches": rank["launches"]["entropy_terms_owned"],
            "max_abs_err": rows_r["errs"]["entropy_terms_owned"],
            **main_path(rows_r["entropy_terms_owned"])})
        for name in ("pair_counts", "entropy_terms", "entropy_terms_owned",
                     "domain_scores_weak"):
            if rows_r[name]:
                log(f"[shard-kernels] rank {r} {name}: "
                    f"{fmt(main_path(rows_r[name]))}")
    # 4o: each rank's K1, K2 and K5 (integer mode) inputs as paths of
    # those kernels
    for r in range(SHARD_WORLD):
        rows_r, rank = mesh["rows"][r], mesh[f"rank{r}"]
        for entry in kernels:
            name = entry["name"]
            if rows_r.get(name):
                entry["paths"].append({
                    "path": f"mesh r{r} (1M / {SHARD_WORLD})",
                    "launches": rank["launches"][name],
                    "max_abs_err": rows_r["errs"][name],
                    **main_path(rows_r[name])})
                log(f"[mesh-kernels] rank {r} {name}: "
                    f"{fmt(main_path(rows_r[name]))}")
    # 4p: each rank's K1 (its local rows) and K2 (the global counts)
    # inputs as paths of those kernels
    for r in range(SHARD_WORLD):
        rows_r, rank = pl["rows"][r], pl[f"rank{r}"]
        for entry in kernels:
            name = entry["name"]
            if rows_r.get(name):
                entry["paths"].append({
                    "path": f"process-local r{r} (1M / {SHARD_WORLD}, "
                            f"{rank['local_rows']} local rows)",
                    "launches": rank["launches"][name],
                    "max_abs_err": rows_r["errs"][name],
                    **main_path(rows_r[name])})
                log(f"[process-local-kernels] rank {r} {name}: "
                    f"{fmt(main_path(rows_r[name]))}")
    # 4r: the launches inside the served requests, by path
    for entry in kernels:
        entry["served_launches"] = {
            p["path"]: p["launches"] for p in entry["paths"]
            if p["path"].startswith("served")}
        if entry["name"] in ("pair_counts", "entropy_terms",
                             "domain_scores_weak") \
                and not any(entry["served_launches"].values()):
            fail(f"4r: {entry['name']} was not launched inside a served "
                 "request")
    # K3 and K4: the main path's heaviest call of each; per traced path and
    # rank its launches, the calls of distinct structure held bitwise and
    # (traced paths) its heaviest call's times
    gbdt_replaces = {
        "gbdt_hist": ("delphi_tpu/models/gbdt.py:157",
                      "_build_tree's histograms :157-163 and leaf sums "
                      ":220-222 (jitted XLA, not Pallas)"),
        "gbdt_split": ("delphi_tpu/models/gbdt.py:181",
                       "_build_tree's cumsum, gain and argmax :181-215 "
                       "(jitted XLA, not Pallas)"),
        "gbdt_route": ("delphi_tpu/models/gbdt.py:217",
                       "_build_tree's routing :217-218 (jitted XLA, not "
                       "Pallas)"),
        "gbdt_predict": ("delphi_tpu/models/gbdt.py:230",
                         "_predict_tree :230 and _predict_boosted :373 "
                         "(jitted XLA, not Pallas)")}
    for name in GBDT_KERNELS:
        top = gbdt_rows[GBDT_MAIN_PATH][name]
        entry_paths = []
        for p, rec in recorded.items():
            e = {"path": p, "launches": path_launches[p].get(name, 0),
                 **rec["gbdt_held"][name]}
            if name in gbdt_rows[p]:
                e["heaviest"] = {k: v for k, v in gbdt_rows[p][name].items()
                                 if k not in ("bytes_ms", "ops_ms")}
            entry_paths.append(e)
        for plane, tag in ((shard, "shard"), (mesh, "mesh"),
                           (pl, "process-local")):
            for r in range(SHARD_WORLD):
                held = plane["rows"][r].get("gbdt_held")
                if held:
                    entry_paths.append({
                        "path": f"{tag} r{r}",
                        "launches": plane[f"rank{r}"]["launches"].get(name, 0),
                        **held[name]})
        kernels.append({
            "name": name, "route": "cuda",
            "source": "delphi_tpu_torch/csrc/gbdt.cu",
            "replaces": gbdt_replaces[name][0],
            "tpu_source": gbdt_replaces[name][1],
            "main_path": GBDT_MAIN_PATH,
            "launches": path_launches[GBDT_MAIN_PATH][name],
            "max_abs_err": max(e["max_abs_err"] for e in entry_paths),
            "calls_checked": sum(e["calls_checked"] for e in entry_paths),
            "layouts": sorted({json.dumps(x) for e in entry_paths
                               for x in e["layouts"]}),
            "max_nodes": max(e["max_nodes"] for e in entry_paths),
            "ms": top["ms"], "kernel_ms": top["kernel_ms"],
            "host_ms": top["host_ms"], "launch_floor_ms": floor["ms"],
            "plain_ms": top["plain_ms"], "bound_ms": top["bound_ms"],
            "bound_by": "bytes" if top["bytes_ms"] >= top["ops_ms"]
            else "operations",
            "library_ms": top["library_ms"], "shape": top["shape"],
            **({"order_chain": top["order_chain"],
                "order_floor_ms": top["order_floor_ms"],
                "add_latency_ns": ADD_NS[0]} if name == "gbdt_hist" else {}),
            **({"edges": edges} if name in ("gbdt_hist", "gbdt_split")
               else {"edges": rp_edges}),
            **({"launch_floor_kernel_ms": floor["kernel_ms"]}
               if name == "gbdt_route" else {}),
            "paths": entry_paths, "per_round": rounds, "ok": True})
    # K10: the main path's heaviest call of each; per traced path its
    # launches, the calls of distinct structure held bitwise and its
    # heaviest call's times
    for name in K10_KERNELS:
        top = k10_rows[K10_MAIN_PATH][name]
        entry_paths = []
        for p, rec in recorded.items():
            e = {"path": p, "launches": path_launches[p].get(name, 0),
                 **rec["k10_held"][name]}
            if name in k10_rows[p]:
                e["heaviest"] = {k: v for k, v in k10_rows[p][name].items()
                                 if k not in ("bytes_ms", "ops_ms")}
            entry_paths.append(e)
        kernels.append({
            "name": name, "route": "cuda",
            "source": "delphi_tpu_torch/csrc/linear.cu",
            "replaces": "delphi_tpu/models/linear.py:118",
            "also_replaces": (["delphi_tpu/models/linear.py:58",
                               "delphi_tpu/models/linear.py:194"]
                              if name == "adam_step" else []),
            "tpu_source": K10_REPLACES[name],
            "main_path": K10_MAIN_PATH,
            "launches": path_launches[K10_MAIN_PATH][name],
            "max_abs_err": max(e["max_abs_err"] for e in entry_paths),
            "calls_checked": sum(e["calls_checked"] for e in entry_paths),
            "ms": top["ms"], "kernel_ms": top["kernel_ms"],
            "host_ms": top["host_ms"], "launch_floor_ms": floor["ms"],
            "plain_ms": top["plain_ms"], "bound_ms": top["bound_ms"],
            "bound_by": "bytes" if top["bytes_ms"] >= top["ops_ms"]
            else "operations",
            "library_ms": top["library_ms"], "shape": top["shape"],
            **({"order_chain": top["order_chain"],
                "order_floor_ms": top["order_floor_ms"],
                "add_latency_ns": ADD_NS[0]}
               if name == "logreg_backward" else {}),
            "edges": lr_edges, "fit": logistic_run, "paths": entry_paths,
            "ok": True})
    o_rows = shard["rows"][0]["entropy_terms_owned"]
    o_bytes = sum(r["bytes_ms"] for r in o_rows)
    o_ops = sum(r["ops_ms"] for r in o_rows)
    owned = owned_paths[0]
    kernels.append(
        {"name": "entropy_terms_owned", "route": "cuda",
         "source": "delphi_tpu_torch/csrc/entropy.cu",
         "replaces": "delphi_tpu/ops/pallas_kernels.py:186",
         "tpu_source": "delphi_tpu/ops/pallas_kernels.py:_entropy_kernel "
                       "(K2's gather modes: the pairs a rank owns)",
         "main_path": owned["path"], "launches": owned["launches"],
         "max_abs_err": max(p["max_abs_err"] for p in owned_paths),
         "ms": owned["ms"], "kernel_ms": owned["kernel_ms"],
         "host_ms": owned["host_ms"], "launch_floor_ms": floor["ms"],
         "plain_ms": owned["plain_ms"], "bound_ms": max(o_bytes, o_ops),
         "bound_by": "bytes" if o_bytes >= o_ops else "operations",
         "library_ms": None, "paths": owned_paths,
         "checks": shard["checks"], "ok": True})
    k8 = esc["escalation"]["k8"]
    programs = [
        {"name": "joint_ascent", "route": "pytorch",
         "source": "delphi_tpu_torch/ops/joint.py",
         "replaces": "delphi_tpu/ops/joint.py:46",
         "launches": esc["escalation"]["k8_launches"],
         "ms": sum(r["ms"] for r in k8),
         "bound_ms": sum(r["bound_ms"] for r in k8), "bound_by": "bytes",
         "per_launch": k8, "hand_kernel": False},
    ]
    log(f"[total] {time.perf_counter() - t_start:.1f} s from start to the "
        "result lines")
    log(f"[report] 4n summary: {json.dumps(report_res, default=str)}")
    log(f"[live] 4q summary: {json.dumps(live_res, default=str)}")
    log(f"[served] 4r summary: "
        f"{json.dumps(served['summary'], default=str)}")
    log(f"[fleet] 4s summary: {json.dumps(fleet_res, default=str)}")
    log(f"[gauntlet] 4t summary: {json.dumps(gauntlet_res, default=str)}")
    log(f"[load] 4u summary: {json.dumps(load_res, default=str)}")
    log(f"[timing] kernel_ms rows from bare launches: {bare_rows}")
    print(json.dumps({"kernels": kernels, "pytorch_programs": programs}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
