"""RepairMisc: option-driven helper utilities (``delphi.misc``).

The JAX package's `misc.py` on the port's session, table, cluster and
depgraph modules: apply repairs, column stats, flatten, q-gram k-means
input splitting, NULL injection, histograms, error maps and dependency
graphs, on pandas frames. Input splitting runs its k-means and the
dependency graph its pair counts and entropies (kernels K1 and K2) on the
port's device.
"""

from typing import Dict, List

import numpy as np
import pandas as pd

from delphi_tpu_torch.session import AnalysisException, get_session
from delphi_tpu_torch.table import encode_table
from delphi_tpu_torch.utils import argtype_check, setup_logger

_logger = setup_logger()


class RepairMisc:
    """Interface to provide helper functionalities."""

    def __init__(self) -> None:
        super().__init__()
        self.opts: Dict[str, str] = {}
        self._session = get_session()

    @argtype_check
    def option(self, key: str, value: str) -> "RepairMisc":
        self.opts[str(key)] = str(value)
        return self

    @argtype_check
    def options(self, options: Dict[str, str]) -> "RepairMisc":
        self.opts.update(options)
        return self

    @property
    def _db_name(self) -> str:
        return self.opts.get("db_name", "")

    @property
    def _target_attr_list(self) -> str:
        return self.opts.get("target_attr_list", "")

    @property
    def _num_bins(self) -> int:
        return int(self.opts.get("num_bins", "8"))

    def _parse_option(self, key: str, default: str) -> str:
        return self.opts.get(key, default)

    def _check_required_options(self, required: List[str]) -> None:
        if not all(opt in self.opts for opt in required):
            raise ValueError("Required options not found: {}".format(", ".join(required)))

    def _table(self, name_key: str = "table_name") -> pd.DataFrame:
        return self._session.resolve(self._db_name, self.opts[name_key])

    # ------------------------------------------------------------------

    def repair(self) -> pd.DataFrame:
        """Applies predicted repair updates into an input table
        (RepairMiscApi.scala:184-247)."""
        self._check_required_options(["repair_updates", "table_name", "row_id"])
        from delphi_tpu_torch.model import repair_attrs_from
        updates = self._session.table(self.opts["repair_updates"]) \
            if isinstance(self.opts["repair_updates"], str) else self.opts["repair_updates"]
        base = self._table()
        row_id = self.opts["row_id"]
        table = encode_table(base, row_id)
        kinds = {c.name: c.kind for c in table.columns if c.is_numeric}
        return repair_attrs_from(updates, base, row_id, kinds)

    def describe(self) -> pd.DataFrame:
        """Column stats: distinct/min/max/null counts, avg/max length,
        equi-width histogram (RepairMiscApi.scala:249-274)."""
        self._check_required_options(["table_name"])
        df = self._table()
        rows = []
        for name in df.columns:
            s = df[name]
            lens = s.dropna().astype(str).str.len()
            is_num = pd.api.types.is_numeric_dtype(s.dtype)
            hist = None
            if is_num and s.notna().any():
                counts, _ = np.histogram(s.dropna().to_numpy(), bins=self._num_bins)
                total = counts.sum()
                hist = (counts / total).tolist() if total else None
            rows.append({
                "attrName": name,
                "distinctCnt": int(s.nunique(dropna=True)),
                "min": str(s.min()) if is_num and s.notna().any() else None,
                "max": str(s.max()) if is_num and s.notna().any() else None,
                "nullCnt": int(s.isna().sum()),
                "avgLen": int(lens.mean()) if len(lens) else 0,
                "maxLen": int(lens.max()) if len(lens) else 0,
                "hist": hist,
            })
        return pd.DataFrame(rows)

    def flatten(self) -> pd.DataFrame:
        """(row_id, attribute, value) long view (RepairMiscApi.scala:41-49).

        Values CAST to string per source column BEFORE the melt (vectorized
        over each column's distinct values) — identical output to the
        per-value formatting since a typed column formats every cell the
        same way (ints as ``str(int)``, floats as ``str(float)``)."""
        from delphi_tpu_torch.table import _value_strings, column_kind

        self._check_required_options(["table_name", "row_id"])
        df = self._table()
        row_id = self.opts["row_id"]
        value_cols = [c for c in df.columns if c != row_id]
        cast = pd.DataFrame({c: _value_strings(df[c], column_kind(df[c]))
                             for c in value_cols})
        cast[row_id] = df[row_id].to_numpy()
        out = cast.melt(id_vars=[row_id], value_vars=value_cols,
                        var_name="attribute", value_name="value")
        return out

    def splitInputTable(self) -> pd.DataFrame:
        """Clusters rows into k groups over bag-of-q-gram features so cleaning
        can run per-split (RepairMiscApi.scala:78-153). The featurization is a
        hashed q-gram bag and the k-means runs on the port's device."""
        self._check_required_options(["table_name", "row_id", "k"])
        if not self.opts["k"].isdigit():
            raise ValueError(f"Option 'k' must be an integer, but '{self.opts['k']}' found")
        q = int(self._parse_option("q", "2"))
        alg = self._parse_option("clustering_alg", "bisect-kmeans")
        if alg not in ("bisect-kmeans", "kmeans++"):
            raise ValueError(f"Unknown clustering algorithm found: {alg}")
        df = self._table()
        row_id = self.opts["row_id"]
        target_attrs = [a for a in self._target_attr_list.split(",") if a] \
            or [c for c in df.columns if c != row_id]
        unknown = [a for a in target_attrs if a not in df.columns]
        if unknown:
            raise AnalysisException(
                f"Columns '{', '.join(unknown)}' do not exist in '{self.opts['table_name']}'")

        from delphi_tpu_torch.ops.cluster import bisecting_kmeans, kmeans, qgram_features
        feats = qgram_features(df[target_attrs], q)
        cluster = bisecting_kmeans if alg == "bisect-kmeans" else kmeans
        labels = cluster(feats, int(self.opts["k"]), seed=0)
        return pd.DataFrame({row_id: df[row_id], "k": labels})

    def injectNull(self) -> pd.DataFrame:
        """Randomly NULLs cells of the target attributes
        (RepairMiscApi.scala:155-182)."""
        self._check_required_options(["table_name", "target_attr_list"])
        if "null_ratio" in self.opts:
            try:
                ratio = float(self.opts["null_ratio"])
                ok = 0.0 < ratio <= 1.0
            except ValueError:
                ok = False
            if not ok:
                raise ValueError(
                    "Option 'null_ratio' must be a float in (0.0, 1.0], "
                    f"but '{self.opts['null_ratio']}' found")
            ratio = float(self.opts["null_ratio"])
        else:
            ratio = 0.01

        df = self._table().copy()
        targets = [a for a in self._target_attr_list.split(",") if a] or list(df.columns)
        unknown = [a for a in targets if a not in df.columns]
        if unknown:
            raise AnalysisException(
                f"Columns '{', '.join(unknown)}' do not exist in '{self.opts['table_name']}'")
        seed = self.opts.get("seed")
        if seed is not None and not str(seed).isdigit():
            raise ValueError(
                f"Option 'seed' must be a non-negative integer, but '{seed}' found")
        rng = np.random.RandomState(int(seed) if seed is not None else None)
        for attr in targets:
            mask = rng.rand(len(df)) <= ratio
            col = df[attr]
            if pd.api.types.is_integer_dtype(col.dtype) and mask.any():
                col = col.astype("float64")
            col = col.mask(mask)
            df[attr] = col
        return df

    def toHistogram(self) -> pd.DataFrame:
        """Per-attribute (value, cnt) histograms for discrete targets
        (RepairMiscApi.scala:276-301)."""
        self._check_required_options(["table_name", "targets"])
        df = self._table()
        targets = [a for a in self.opts["targets"].split(",") if a]
        rows = []
        for attr in targets:
            if attr not in df.columns or pd.api.types.is_numeric_dtype(df[attr].dtype):
                continue
            counts = df[attr].dropna().value_counts()
            rows.append({
                "attribute": attr,
                "histogram": [{"value": str(v), "cnt": int(c)}
                              for v, c in counts.items()],
            })
        return pd.DataFrame(rows, columns=["attribute", "histogram"])

    def toErrorMap(self) -> pd.DataFrame:
        """Star-grid visualization of error cells (RepairMiscApi.scala:303-347)."""
        self._check_required_options(["table_name", "row_id", "error_cells"])
        err = self._session.table(self.opts["error_cells"])
        row_id = self.opts["row_id"]
        if not {row_id, "attribute"}.issubset(err.columns):
            raise AnalysisException(
                f"Table '{self.opts['error_cells']}' must have '{row_id}' and "
                "'attribute' columns")
        df = self._table()
        attrs_to_repair = set(err["attribute"].unique())
        err_keys = set(zip(err[row_id], err["attribute"]))
        value_cols = [c for c in df.columns if c != row_id]
        maps = []
        for rid in df[row_id]:
            maps.append("".join(
                "*" if (c in attrs_to_repair and (rid, c) in err_keys) else "-"
                for c in value_cols))
        return pd.DataFrame({row_id: df[row_id], "error_map": maps})

    def generateDepGraph(self) -> None:
        """Writes a dependency-graph dot/SVG for an input table
        (RepairMiscApi.scala:349-377)."""
        self._check_required_options(["path", "table_name"])
        from delphi_tpu_torch.depgraph import generate_dep_graph
        df = self._table()
        targets = [a for a in self._target_attr_list.split(",") if a] or list(df.columns)
        generate_dep_graph(
            self.opts["path"], df, "svg", targets,
            int(self._parse_option("max_domain_size", "100")),
            int(self._parse_option("max_attr_value_num", "30")),
            int(self._parse_option("max_attr_value_length", "70")),
            float(self._parse_option("pairwise_attr_stat_threshold", "1.0")),
            len(self._parse_option("edge_label", "")) > 0,
            self._parse_option("filename_prefix", "depgraph"),
            len(self._parse_option("overwrite", "")) > 0)
