"""The port's detectors and denial-constraint engine against the JAX
package's on the same seeded tables, on the CPU: identical cell frames for
every detector class, identical violation masks for every constraint route
(single EQ key, composite EQ keys, IQ, LT/GT, all-IQ inclusion-exclusion,
mixed residuals, one-tuple), bitwise-equal percentile fences, and the
same parsed constraints.
"""

import numpy as np
import pandas as pd
import pytest
import torch

import delphi_tpu as J  # noqa: F401  (JAX package set-up)
import delphi_tpu_torch as T
from delphi_tpu import constraints as jc
from delphi_tpu import errors as je
from delphi_tpu import table as jt
from delphi_tpu.ops import detect as jd
from delphi_tpu_torch import constraints as tc
from delphi_tpu_torch import errors as te
from delphi_tpu_torch import table as tt
from delphi_tpu_torch.ops import detect as td
from delphi_tpu_torch.utils import counters

from conftest import TESTDATA


@pytest.fixture(autouse=True)
def _cpu_device():
    T.set_device("cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    T.set_device(None)


PACKAGES = ((je, jt), (te, tt))


def _detect_both(make, df, targets=None, continuous=()):
    """(JAX frame, port frame) of one detector built by ``make(errors
    module)`` over ``df``."""
    frames = []
    for errors, table_mod in PACKAGES:
        table = table_mod.encode_table(df, "tid")
        det = make(errors)
        det.setUp("tid", "test_input", list(continuous),
                  targets if targets is not None else table.column_names,
                  encoded_table=table)
        frames.append(det.detect())
    return frames


def _assert_same(frames, nonempty=True):
    want, got = frames
    if nonempty:
        assert len(want) > 0
    pd.testing.assert_frame_equal(got, want)


def _categorical(n=600, seed=0):
    """city -> state -> region with typos and NULLs (fd_categorical's
    shape), a numeric column and an integral one."""
    rng = np.random.RandomState(seed)
    city = rng.randint(0, 24, n)
    state = np.array([f"state_{c % 12:02d}" for c in city], dtype=object)
    typo = rng.rand(n) < 0.05
    state[typo] = [s[::-1] for s in state[typo]]
    state[rng.rand(n) < 0.05] = None
    region = np.array([f"region_{c % 12 % 4}" for c in city], dtype=object)
    region[rng.rand(n) < 0.05] = None
    amount = rng.normal(100.0, 10.0, n)
    amount[rng.rand(n) < 0.03] *= 10.0
    amount[rng.rand(n) < 0.05] = np.nan
    return pd.DataFrame({
        "tid": np.arange(n),
        "city": [f"city_{c:02d}" for c in city],
        "state": state, "region": region, "amount": amount,
        "qty": rng.randint(0, 9, n),
    })


# --- regex and domain values ------------------------------------------------

REGEX_CASES = {
    "anchored": ("state", "^state_[0-9]{2}$"),
    "partial match": ("state", "ate_0"),
    "alternation": ("region", "(region_1|region_2)"),
    "invalid regex": ("state", "(["),
    "empty regex": ("state", " "),
    "not a target": ("city", "^city"),
}


@pytest.mark.parametrize("case", sorted(REGEX_CASES))
def test_regex_detector_matches_jax(case):
    attr, regex = REGEX_CASES[case]
    targets = ["state", "region"]
    frames = _detect_both(lambda e: e.RegExErrorDetector(attr, regex),
                          _categorical(), targets=targets)
    _assert_same(frames, nonempty=case not in (
        "invalid regex", "empty regex", "not a target"))
    if case == "anchored":
        # NULLs count as non-matching
        got = frames[1]
        assert got["tid"].isin(
            _categorical()["tid"][_categorical()["state"].isna()]).any()


DOMAIN_CASES = {
    "given list": dict(attr="region", values=["region_0", "region_2"]),
    "given list, regex characters": dict(attr="state",
                                         values=["state_0.", "state_1[01]"]),
    "autofill": dict(attr="state", autofill=True, min_count_thres=4),
    "autofill, high threshold": dict(attr="state", autofill=True,
                                     min_count_thres=40),
    "autofill, nothing passes": dict(attr="region", autofill=True,
                                     min_count_thres=10_000),
    "continuous attribute": dict(attr="amount", autofill=True),
}


@pytest.mark.parametrize("case", sorted(DOMAIN_CASES))
def test_domain_values_matches_jax(case):
    kw = DOMAIN_CASES[case]
    frames = _detect_both(lambda e: e.DomainValues(**kw), _categorical(),
                          continuous=["amount"])
    _assert_same(frames, nonempty=case != "continuous attribute")


# --- outliers and percentiles -----------------------------------------------

def _bits(x):
    return np.asarray(x, dtype=np.float64).view(np.int64)


@pytest.mark.parametrize("size", [1, 2, 3, 4, 5, 8, 1001])
def test_percentile_batch_bitwise_equals_numpy(size):
    rng = np.random.RandomState(size)
    pools = [rng.normal(0, 1e3, size),
             np.round(rng.normal(0, 3, size)),       # duplicates
             np.full(size, 7.25),                    # one value
             rng.exponential(1.0, size + 3) * 1e-7]  # another length
    got = td.percentile_batch([torch.from_numpy(p) for p in pools],
                              (25.0, 75.0)).numpy()
    want = np.stack([np.percentile(p, [25.0, 75.0]) for p in pools])
    np.testing.assert_array_equal(_bits(got), _bits(want))


def _numeric(n, seed=1):
    rng = np.random.RandomState(seed)
    df = pd.DataFrame({"tid": np.arange(n), "w": ["x"] * n})
    for j in range(3):
        v = np.round(rng.normal(10.0 * j, 1.0 + j, n), 3 - j)
        v[rng.rand(n) < 0.05] = np.nan
        v[rng.choice(n, 3, replace=False)] = 1e6
        df[f"v{j}"] = v
    df["one"] = np.nan    # a pool of 1 value
    df.loc[5, "one"] = 3.5
    df["two"] = np.nan    # a pool of 2 values
    df.loc[[0, 1], "two"] = [1.0, 4.0]
    df["empty"] = np.nan  # no pool
    return df


@pytest.mark.parametrize("approx", [False, True])
def test_gaussian_outliers_match_jax(approx):
    """Exact fences over every value, and with ``approx_enabled`` over
    150,000 rows the seeded 100,000-value sample: the same cells."""
    n = 150_000 if approx else 2_000
    df = _numeric(n)
    cont = ["v0", "v1", "v2", "one", "two", "empty"]
    frames = _detect_both(
        lambda e: e.GaussianOutlierErrorDetector(approx_enabled=approx), df,
        continuous=cont)
    _assert_same(frames)
    assert {"v0", "v1", "v2"} <= set(frames[1]["attribute"])


def test_outlier_fences_bitwise_equal_numpy():
    """The quartiles the port's fences come from are numpy's: q1/q3 by
    np.percentile on the column's NaN-free pool, bit for bit."""
    df = _numeric(3_000, seed=4)
    table = tt.encode_table(df, "tid")
    for attr in ("v0", "v1", "v2"):
        values = table.column(attr).numeric
        pool = values[~np.isnan(values)]
        got = td.percentile_batch([torch.from_numpy(pool)], (25.0, 75.0))
        np.testing.assert_array_equal(
            _bits(got.numpy()[0]), _bits(np.percentile(pool, [25.0, 75.0])))


# --- scikit-learn-style detectors -------------------------------------------

class _ZScore:
    """A numpy ``fit_predict`` outlier model: -1 beyond 3 deviations."""

    def fit_predict(self, X):
        x = np.asarray(X, dtype=np.float64)[:, 0]
        z = np.abs(x - x.mean()) / (x.std() or 1.0)
        return np.where(z > 3.0, -1, 1)


@pytest.mark.parametrize("parallel", [False, True])
def test_sklearn_backed_detector_matches_jax(parallel):
    df = _numeric(3_000, seed=2).drop(columns=["one", "two", "empty"])
    threshold = 1 if parallel else 10 ** 9
    frames = _detect_both(
        lambda e: e.ScikitLearnBackedErrorDetector(
            _ZScore, parallel_mode_threshold=threshold, num_parallelism=3),
        df, continuous=["v0", "v1", "v2"])
    _assert_same(frames)
    seq = _detect_both(
        lambda e: e.ScikitLearnBackedErrorDetector(
            _ZScore, parallel_mode_threshold=10 ** 9), df,
        continuous=["v0", "v1", "v2"])[1]
    pd.testing.assert_frame_equal(frames[1], seq)


def test_sklearn_backed_detector_validation():
    with pytest.raises(ValueError, match="fit_predict"):
        te.ScikitLearnBackedErrorDetector(lambda: object())
    with pytest.raises(ValueError, match="num_parallelism"):
        te.ScikitLearnBackedErrorDetector(_ZScore, num_parallelism=0)


def test_lof_detector_matches_jax():
    pytest.importorskip("sklearn")
    rng = np.random.RandomState(0)
    n = 400
    df = pd.DataFrame({"tid": range(n), "w": ["x"] * n})
    for j in range(3):
        col = rng.normal(0, 1, n)
        col[j] = 100.0
        df[f"v{j}"] = col
    frames = _detect_both(lambda e: e.LOFOutlierErrorDetector(
        parallel_mode_threshold=1, num_parallelism=2), df,
        continuous=["v0", "v1", "v2"])
    _assert_same(frames)


# --- parsing ----------------------------------------------------------------

PARSE_CASES = {
    "two-tuple": ["t1&t2&EQ(t1.a,t2.a)&IQ(t1.b,t2.b)"],
    "one-tuple": ['t1&EQ(t1.Sex,"Female")&EQ(t1.Relationship,"Husband")',
                  "t1&GT(t1.c,'3')&LT(t1.c,'7')"],
    "fd sugar": ["a->b", " b -> c "],
    "unknown attribute dropped": ["t1&t2&EQ(t1.a,t2.a)&IQ(t1.b,t2.b)",
                                  "t1&t2&EQ(t1.zzz,t2.zzz)&IQ(t1.b,t2.b)"],
    "garbage": ["garbage input", "t1&t2&EQ(t1.a,t2.a)", "a->b->c", "",
                "t1&t2&XX(t1.a,t2.a)&IQ(t1.b,t2.b)"],
    "all unknown": ["zz->yy"],
}


def _ir(parsed):
    return ([[(p.sign, type(p.left).__name__, str(p.left),
               type(p.right).__name__, str(p.right)) for p in preds]
             for preds in parsed.predicates], parsed.references)


@pytest.mark.parametrize("case", sorted(PARSE_CASES))
def test_parse_and_verify_matches_jax(case):
    stmts = PARSE_CASES[case]
    attrs = ["a", "b", "c", "Sex", "Relationship"]
    want = jc.parse_and_verify_constraints(stmts, "t", attrs)
    got = tc.parse_and_verify_constraints(stmts, "t", attrs)
    assert _ir(got) == _ir(want)
    assert got.is_empty == want.is_empty
    assert got.is_empty == (case in ("garbage", "all unknown"))


def test_constraint_statements_load_like_jax(tmp_path):
    path = tmp_path / "dc.txt"
    path.write_text("a->b\nt1&t2&EQ(t1.a,t2.a)&IQ(t1.c,t2.c)\n")
    assert tc.load_constraint_stmts_from_file(str(path)) \
        == jc.load_constraint_stmts_from_file(str(path))
    assert tc.load_constraint_stmts_from_file(str(tmp_path / "none")) == []
    s = " a->b ; ;t1&t2&EQ(t1.a,t2.a)&IQ(t1.c,t2.c)"
    assert tc.load_constraint_stmts_from_string(s) \
        == jc.load_constraint_stmts_from_string(s)


# --- denial constraints -----------------------------------------------------

def _suite_table(n=500, seed=3):
    rng = np.random.RandomState(seed)
    df = pd.DataFrame({
        "tid": np.arange(n).astype(str),
        "zip": rng.randint(0, 40, n).astype(str),
        "city": rng.randint(0, 30, n).astype(str),
        "state": rng.randint(0, 8, n).astype(str),
        "salary": rng.randint(10, 99, n).astype(str),
        "rate": rng.randint(1, 50, n).astype(str),
        "score": np.round(rng.normal(50, 10, n), 1),
    })
    for c in ("city", "state", "salary", "score"):
        df.loc[rng.choice(n, 25, replace=False), c] = None
    return df


# route -> constraint: the nine-constraint suite of the JAX package's
# device/host equivalence test, plus the routes it does not reach
SUITE = {
    "eq keys only": "t1&t2&EQ(t1.zip,t2.zip)&EQ(t1.state,t2.state)",
    "single eq + iq": "t1&t2&EQ(t1.zip,t2.zip)&IQ(t1.city,t2.city)",
    "single eq + cross-attribute iq":
        "t1&t2&EQ(t1.zip,t2.zip)&IQ(t1.city,t2.state)",
    "single eq + lt": "t1&t2&EQ(t1.state,t2.state)&LT(t1.salary,t2.salary)",
    "single eq + gt": "t1&t2&EQ(t1.state,t2.state)&GT(t1.rate,t2.rate)",
    "composite eq + iq":
        "t1&t2&EQ(t1.zip,t2.zip)&EQ(t1.state,t2.state)&IQ(t1.city,t2.city)",
    "composite eq + lt": "t1&t2&EQ(t1.zip,t2.zip)&EQ(t1.city,t2.city)"
                         "&LT(t1.salary,t2.salary)",
    "all-iq, two": "t1&t2&EQ(t1.zip,t2.zip)&IQ(t1.city,t2.city)"
                   "&IQ(t1.salary,t2.salary)",
    "all-iq, composite key": "t1&t2&EQ(t1.zip,t2.zip)&EQ(t1.state,t2.state)"
                             "&IQ(t1.city,t2.city)&IQ(t1.rate,t2.rate)",
    "numeric lt": "t1&t2&EQ(t1.city,t2.city)&LT(t1.score,t2.score)",
    "numeric gt, cross-attribute key":
        "t1&t2&EQ(t1.zip,t2.city)&GT(t1.score,t2.score)",
    "mixed residuals": "t1&t2&EQ(t1.zip,t2.zip)&IQ(t1.city,t2.city)"
                       "&GT(t1.rate,t2.rate)",
    "mixed residuals, composite key":
        "t1&t2&EQ(t1.zip,t2.zip)&EQ(t1.state,t2.state)"
        "&LT(t1.salary,t2.salary)&GT(t1.rate,t2.rate)",
    "no eq key": "t1&t2&IQ(t1.state,t2.state)&IQ(t1.zip,t2.zip)",
    "fd sugar": "zip->city",
    "one-tuple": 't1&EQ(t1.state,"3")&IQ(t1.city,"7")',
}


@pytest.mark.parametrize("route", sorted(SUITE))
def test_constraint_route_matches_jax(route):
    """Each route's violation mask equals the JAX package's host route,
    and the detector's cell frame equals the JAX detector's."""
    df = _suite_table()
    stmt = SUITE[route]
    attrs = df.columns.tolist()
    masks = []
    for cons, table_mod, det in ((jc, jt, jd), (tc, tt, td)):
        table = table_mod.encode_table(df, "tid")
        parsed = cons.parse_and_verify_constraints([stmt], "t", attrs)
        assert len(parsed.predicates) == 1
        preds = parsed.predicates[0]
        if all(isinstance(p.right, cons.Constant) for p in preds):
            masks.append(det._one_tuple_violations(table, preds))
        else:
            masks.append(det._two_tuple_violations(table, preds))
    np.testing.assert_array_equal(masks[1], masks[0])
    assert masks[1].any()
    _assert_same(_detect_both(
        lambda e: e.ConstraintErrorDetector(constraints=stmt), df))


def test_constraint_suite_detector_matches_jax():
    """All routes in one detector (the cells of each constraint, in
    constraint order), with a target filter."""
    df = _suite_table(seed=5)
    stmts = ";".join(SUITE.values())
    for targets in (None, ["city", "salary", "score"]):
        _assert_same(_detect_both(
            lambda e: e.ConstraintErrorDetector(constraints=stmts), df,
            targets=targets))


def test_constraint_counters():
    """The device steps count their launches."""
    df = _suite_table()
    table = tt.encode_table(df, "tid")
    parsed = tc.parse_and_verify_constraints(
        [SUITE["all-iq, composite key"], SUITE["numeric lt"]], "t",
        df.columns.tolist())
    counters.clear()
    td.detect_constraint_violations(table, parsed, df.columns.tolist())
    # composite key (1 rank a column), the all-iq base rank and 3 subsets
    # fused on it, 4 inclusion-exclusion counts; one extrema
    assert counters["detect.rank"] == 2 + 1 + 4
    assert counters["detect.sorted_count"] == 4
    assert counters["detect.group_extrema"] == 1


def _brute_force(table, preds):
    """Per-row pairwise oracle for two-tuple constraints (port helpers)."""
    n = table.n_rows
    arrays = []
    for p in preds:
        if p.sign in ("EQ", "IQ"):
            arrays.append((p.sign, *td._shared_codes(
                table, p.left.name, p.right.name)))
        else:
            arrays.append((p.sign,
                           td._comparable_values(table, p.left.name),
                           td._comparable_values(table, p.right.name)))

    def holds(sign, left, right, i, j):
        if sign == "EQ":
            return bool(left[i] == right[j])
        if sign == "IQ":
            return bool(left[i] != right[j])
        lv, rv = left[i], right[j]
        if np.isnan(lv) or np.isnan(rv):
            return False
        return bool(lv < rv) if sign == "LT" else bool(lv > rv)

    out = np.zeros(n, dtype=bool)
    for i in range(n):
        for j in range(n):
            if all(holds(s, lo, ro, i, j) for s, lo, ro in arrays):
                out[i] = True
                break
    return out


@pytest.mark.parametrize("signs", [
    ("EQ", "IQ", "IQ"),
    ("EQ", "IQ", "IQ", "IQ"),
    ("EQ", "IQ", "GT"),
    ("EQ", "LT", "GT"),
    ("IQ", "IQ"),
    ("EQ", "LT"),
    ("EQ", "EQ", "GT"),
    ("EQ", "EQ", "IQ"),
])
def test_two_tuple_matches_brute_force_and_jax(signs):
    rng = np.random.RandomState(7)
    n = 120
    df = pd.DataFrame({
        "tid": range(n),
        "a": rng.randint(0, 4, n).astype(str),
        "b": np.where(rng.rand(n) < 0.15, None,
                      rng.randint(0, 5, n).astype(str)),
        "c": np.where(rng.rand(n) < 0.1, np.nan,
                      rng.randint(0, 6, n).astype(float)),
        "d": rng.randint(0, 3, n).astype(str),
        "e": rng.randint(0, 5, n).astype(float),
    })
    attrs = ["a", "b", "c", "d", "e"]
    masks = []
    for cons, table_mod, det in ((jc, jt, jd), (tc, tt, td)):
        table = table_mod.encode_table(df, "tid")
        preds = [cons.Predicate(sign, cons.AttrRef(attrs[i]),
                                cons.AttrRef(attrs[i]))
                 for i, sign in enumerate(signs)]
        masks.append(det._two_tuple_violations(table, preds))
    np.testing.assert_array_equal(masks[1], masks[0])
    np.testing.assert_array_equal(masks[1], _brute_force(table, preds))


def test_two_tuple_cross_attribute_residuals_match_brute_force():
    rng = np.random.RandomState(3)
    n = 80
    df = pd.DataFrame({
        "tid": range(n),
        "a": rng.randint(0, 3, n).astype(str),
        "b": rng.randint(0, 4, n).astype(str),
        "d": rng.randint(0, 4, n).astype(str),
    })
    table = tt.encode_table(df, "tid")
    preds = [tc.Predicate("EQ", tc.AttrRef("a"), tc.AttrRef("a")),
             tc.Predicate("IQ", tc.AttrRef("b"), tc.AttrRef("d")),
             tc.Predicate("IQ", tc.AttrRef("d"), tc.AttrRef("b"))]
    np.testing.assert_array_equal(td._two_tuple_violations(table, preds),
                                  _brute_force(table, preds))


def _one_tuple_frame():
    return pd.DataFrame({
        "tid": range(8),
        "s": ["apple", "pear", None, "fig", "zoo", "m", "apple", None],
        "n": [1.0, 5.0, 3.0, np.nan, 2.0, 2.5, 7.0, 0.0],
        "k": [1, 2, 3, 4, 5, 6, 7, 8],
    })


@pytest.mark.parametrize("preds", [
    [("EQ", "s", "'apple'")],
    [("IQ", "s", '"apple"')],
    [("LT", "s", "'m'")],
    [("GT", "s", "'m'")],
    [("EQ", "n", "2.5")],
    [("IQ", "n", "2.5")],
    [("LT", "n", "2.5")],
    [("GT", "n", "2.5")],
    [("GT", "k", "3"), ("LT", "k", "7")],
    [("GT", "n", "abc")],
    [("EQ", "s", "'apple'"), ("LT", "n", "5")],
])
def test_one_tuple_matches_jax(preds):
    df = _one_tuple_frame()
    masks = []
    for cons, table_mod, det in ((jc, jt, jd), (tc, tt, td)):
        table = table_mod.encode_table(df, "tid")
        masks.append(det._one_tuple_violations(table, [
            cons.Predicate(sign, cons.AttrRef(a), cons.Constant(v))
            for sign, a, v in preds]))
    np.testing.assert_array_equal(masks[1], masks[0])


def test_adult_and_hospital_constraint_files_match_jax():
    for name in ("adult", "hospital"):
        df = pd.read_csv(TESTDATA / f"{name}.csv", dtype=str) \
            .astype({"tid": int})
        path = str(TESTDATA / f"{name}_constraints.txt")
        _assert_same(_detect_both(
            lambda e: e.ConstraintErrorDetector(constraint_path=path), df))
