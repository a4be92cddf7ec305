"""Incremental repair plane: snapshot manifests, delta planning, and
drift-gated model reuse ("re-repair only what changed").

* :mod:`~delphi_tpu_torch.incremental.manifest` — snapshot manifests
  persisting per-column content fingerprints plus chunked row-block
  fingerprints under ``DELPHI_SNAPSHOT_DIR`` / ``repair.snapshot.dir``
  (atomic, versioned, written through the durable store; the same dict
  and ``snapshot_id`` as the JAX package's for the same table).
* :mod:`~delphi_tpu_torch.incremental.planner` — diffs an incoming table
  against the manifest into clean/dirty columns and unchanged/updated/
  appended rows, then expands the dirty row set through the constraint
  dependency graph (:mod:`~delphi_tpu_torch.incremental.depgraph`).
* :mod:`~delphi_tpu_torch.incremental.executor` — runs detection, attr
  stats, domain analysis and training on the planned row subset only,
  reuses the frozen per-attribute models the drift gate (PSI over the
  snapshot value histograms) clears, and splices the fresh decisions into
  the prior result frame and provenance ledger.
* :mod:`~delphi_tpu_torch.incremental.stream` — the streaming plane:
  chained deltas against a durable generational cursor, idempotent
  re-apply, backpressure and drift-gated background retrains.
"""

from delphi_tpu_torch.incremental.executor import (  # noqa: F401
    incremental_requested, run_incremental, snapshot_dir_for,
)
from delphi_tpu_torch.incremental.manifest import (  # noqa: F401
    MANIFEST_VERSION, build_manifest, load_manifest, load_state,
    merge_manifests, write_snapshot,
)
from delphi_tpu_torch.incremental.planner import (  # noqa: F401
    DeltaPlan, plan_delta,
)
from delphi_tpu_torch.incremental.stream import (  # noqa: F401
    StreamBusy, StreamCommitError, StreamManager, StreamSession,
)
