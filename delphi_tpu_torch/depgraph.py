"""Functional-dependency extraction and attribute dependency graphs.

The JAX package's `depgraph.py` on the port's statistics (DepGraph.scala
behaviors):
* `compute_functional_deps` — FDs implied by EQ/IQ denial constraints
  (DepGraph.scala:257-298).
* `compute_functional_dep_map` — value-level X->Y map from data
  (group by X having exactly one distinct Y; DepGraph.scala:300-317).
* `compute_dep_graph` / `generate_dep_graph` — graphviz dot emission of
  highly-correlated attribute pairs (DepGraph.scala:88-255). The pair
  counts and entropies come from kernels K1 and K2 on the port's device
  (:mod:`delphi_tpu_torch.ops.freq`, :mod:`delphi_tpu_torch.ops.entropy`).
"""

import os
import shutil
import subprocess
from typing import Dict, List, Sequence

import numpy as np
import pandas as pd

from delphi_tpu_torch import constraints as dc
from delphi_tpu_torch.ops.entropy import compute_pairwise_stats
from delphi_tpu_torch.ops.freq import compute_freq_stats
from delphi_tpu_torch.session import AnalysisException
from delphi_tpu_torch.table import EncodedTable, encode_table
from delphi_tpu_torch.utils import setup_logger

_logger = setup_logger()


def compute_functional_deps(df: pd.DataFrame, constraint_path: str,
                            constraints_str: str,
                            target_attrs: Sequence[str]) -> Dict[str, List[str]]:
    """FDs x -> y from two-predicate EQ/IQ constraints, cycle-guarded
    (DepGraph.scala:275-292)."""
    stmts = dc.load_constraint_stmts_from_file(constraint_path) \
        + dc.load_constraint_stmts_from_string(constraints_str)
    parsed = dc.parse_and_verify_constraints(stmts, "input", list(df.columns))

    fd_map: Dict[str, List[str]] = {}

    def has_no_cycle(x: str, y: str) -> bool:
        return y not in fd_map.get(x, []) and x not in fd_map.get(y, [])

    for preds in parsed.predicates:
        if len(preds) != 2:
            continue
        signs = {p.sign for p in preds}
        if signs != {"EQ", "IQ"}:
            continue
        if not all(len(p.references) == 1 for p in preds):
            continue
        eq = next(p for p in preds if p.sign == "EQ")
        iq = next(p for p in preds if p.sign == "IQ")
        x, y = eq.references[0], iq.references[0]
        if y in target_attrs and has_no_cycle(x, y):
            fd_map.setdefault(y, [])
            if x not in fd_map[y]:
                fd_map[y].append(x)

    return {k: sorted(v) for k, v in fd_map.items()}


def compute_functional_dep_map(df: pd.DataFrame, x: str, y: str) -> Dict[str, str]:
    """Value map {x_value: y_value} for x groups with exactly one distinct y
    (DepGraph.scala:300-317). NULL keys/values are excluded."""
    sub = df[[x, y]].dropna()
    grouped = sub.groupby(sub[x].astype(str))[y]
    out: Dict[str, str] = {}
    for key, values in grouped:
        uniq = values.astype(str).unique()
        if len(uniq) == 1:
            out[str(key)] = str(uniq[0])
    return out


def compute_dep_graph(df: pd.DataFrame, target_attrs: Sequence[str],
                      max_domain_size: int, max_attr_value_num: int,
                      max_attr_value_length: int,
                      pairwise_attr_corr_threshold: float,
                      edge_label: bool) -> str:
    """Builds the graphviz dot text for attribute dependencies
    (DepGraph.scala:88-197)."""
    assert target_attrs

    table = encode_table(df, df.columns[0]) if df.columns[0] not in target_attrs \
        else _encode_all(df)
    domain_stats = {c.name: c.domain_size for c in table.columns
                    if c.name in target_attrs and c.domain_size <= max_domain_size}
    if len(domain_stats) < 2:
        raise AnalysisException(
            "At least two candidate attributes needed to build a dependency graph")

    attrs = list(domain_stats)
    pairs = []
    for i in range(len(attrs)):
        for j in range(i + 1, len(attrs)):
            x, y = attrs[i], attrs[j]
            if domain_stats[x] < domain_stats[y]:
                x, y = y, x
            pairs.append((x, y))

    n = table.n_rows
    freq = compute_freq_stats(table, attrs, pairs, 0.0)
    pairwise = compute_pairwise_stats(n, freq, pairs, domain_stats)

    selected = []
    for x, y in pairs:
        for attr, h in pairwise.get(x, []):
            if attr == y and max(h, 0.0) <= pairwise_attr_corr_threshold:
                selected.append((x, y))
    if not selected:
        raise AnalysisException(
            f"No highly-correlated attribute pair "
            f"(threshold: {pairwise_attr_corr_threshold}) found")

    nodes: List[str] = []
    edges: List[str] = []
    hub_nodes: List[tuple] = []
    next_node_id = [0]

    def norm_html(s: str) -> str:
        return s.replace("&", "&amp;").replace("<", "&lt;").replace(">", "&gt;")

    def trim(s: str) -> str:
        return s if len(s) <= max_attr_value_length else s[:max_attr_value_length] + "..."

    def gen_node(attr: str, values: List[str], truncate: bool):
        nn = f"{attr}_{next_node_id[0]}"
        next_node_id[0] += 1
        vwi = list(enumerate(values))
        if truncate:
            vwi.append((-1, "..."))
        entries = "\n    ".join(
            f'<tr><td port="{i}">{norm_html(trim(v))}</td></tr>' for i, v in vwi)
        hub_nodes.append((nn, attr))
        nodes.append(
            f'"{nn}" [color="black" label=<\n  <table>\n'
            f'    <tr><td bgcolor="black" port="nodeName">'
            f'<i><font color="white">{nn}</font></i></td></tr>\n'
            f"    {entries}\n  </table>>];")
        return nn, {v: i for i, v in vwi}

    for x, y in selected:
        m = freq.pair(x, y)[1:, 1:]  # both sides non-NULL
        vx = table.column(x).vocab
        vy = table.column(y).vocab
        xs_with_any = [i for i in range(len(vx)) if m[i].sum() > 0]
        truncate = max_attr_value_num < len(xs_with_any)
        xs_sel = xs_with_any[:max_attr_value_num]
        if not xs_sel:
            continue
        y_vals = sorted({j for i in xs_sel for j in np.nonzero(m[i])[0]})
        xn, xmap = gen_node(x, [str(vx[i]) for i in xs_sel], truncate)
        yn, ymap = gen_node(y, [str(vy[j]) for j in y_vals], False)
        for i in xs_sel:
            total = int(m[i].sum())
            for j in np.nonzero(m[i])[0]:
                cnt = int(m[i, j])
                p = cnt / total
                w = 0.1 + np.log(cnt) / (0.1 + np.log(n / max(len(xmap), 1)))
                color = f"gray{int(100.0 * (1.0 - p))}"
                label = f'label="{cnt}/{total}"' if edge_label else ""
                edges.append(
                    f'"{xn}":{xmap[str(vx[i])]} -> "{yn}":{ymap[str(vy[j])]} '
                    f'[ color="{color}" penwidth="{w}" {label} ];')

    for nn, hub in hub_nodes:
        nodes.append(f'"{hub}" [ shape="box" ];')
        edges.append(f'"{hub}" -> "{nn}":nodeName [ arrowhead="diamond" penwidth="1.0" ];')

    if not nodes:
        raise AnalysisException(
            "Failed to a generate dependency graph because no correlated attribute found")
    body = "\n  ".join(sorted(nodes)) + "\n  " + "\n  ".join(sorted(edges))
    return ("digraph {\n"
            '  graph [pad="0.5" nodesep="1.0" ranksep="4" fontname="Helvetica" rankdir=LR];\n'
            "  node [shape=plaintext]\n\n  " + body + "\n}\n")


def _encode_all(df: pd.DataFrame) -> EncodedTable:
    tmp = df.copy()
    tmp.insert(0, "__rid__", range(len(df)))
    return encode_table(tmp, "__rid__")


VALID_IMAGE_FORMATS = {"png", "svg"}


def generate_dep_graph(output_dir: str, df: pd.DataFrame, fmt: str,
                       target_attrs: Sequence[str], max_domain_size: int,
                       max_attr_value_num: int, max_attr_value_length: int,
                       pairwise_attr_corr_threshold: float, edge_label: bool,
                       filename_prefix: str, overwrite: bool) -> None:
    """Writes `<prefix>.dot` (and `<prefix>.<fmt>` if graphviz's `dot` is on
    PATH) into ``output_dir`` (DepGraph.scala:222-255)."""
    graph = compute_dep_graph(df, target_attrs, max_domain_size, max_attr_value_num,
                              max_attr_value_length, pairwise_attr_corr_threshold,
                              edge_label)
    if fmt.lower() not in VALID_IMAGE_FORMATS:
        raise AnalysisException(f"Invalid image format: {fmt}")
    if overwrite and os.path.isdir(output_dir):
        shutil.rmtree(output_dir, ignore_errors=True)
    try:
        os.mkdir(output_dir)
    except OSError:
        raise AnalysisException(
            f"`overwrite` is set to true, but could not remove output dir path "
            f"'{output_dir}'" if overwrite
            else f"output dir path '{output_dir}' already exists")
    dot_path = os.path.join(output_dir, f"{filename_prefix}.dot")
    with open(dot_path, "w") as f:
        f.write(graph)
    if shutil.which("dot"):
        out_path = os.path.join(output_dir, f"{filename_prefix}.{fmt}")
        try:
            with open(out_path, "w") as out:
                subprocess.run(["dot", f"-T{fmt}", dot_path], stdout=out, check=True)
        except Exception:
            _logger.warning("Cannot generate image file with the `dot` command.")
