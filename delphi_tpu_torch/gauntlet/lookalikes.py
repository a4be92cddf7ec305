"""Seeded lookalikes for the reference testdata tree, where it is absent
(the port's copy of the JAX package's ``delphi_tpu/gauntlet/lookalikes.py``;
numpy and pandas only).

Hosts without the reference testdata tree would fail 60+ tests at
collection. :func:`materialize_testdata` writes deterministic lookalike
files — same filenames, same shapes, same statistical skeleton as the
reference fixtures — into a local directory (``tests/conftest.py`` takes
the JAX package's copy of this module; ``DELPHI_TESTDATA`` overrides the
location both ways).

The lookalikes are *pinned* by the test suite: the adult table's null
positions, value histograms, FD structure (Relationship -> Sex with two
planted violations at tids 4 and 11), and the repair ground truth in
``adult_clean.csv`` / ``adult_repair.csv`` all satisfy the exact
assertions in tests/test_misc.py, test_model.py, test_table.py,
test_errors.py and test_model_features.py. The hospital table keeps the
reference's 1000x19 shape and FD grammar; flights keeps the raha layout
(wide dirty table + long ``correct_val`` truth). Files that encode
measurements of the *real* datasets (iris/boston RMSE baselines,
hospital error-cell inventories) are deliberately NOT synthesized —
tests that need them skip instead.

Everything is derived from fixed tables or ``numpy.random.RandomState``
streams: two materializations are byte-identical.
"""

import os
import tempfile
from typing import Dict, List

import numpy as np
import pandas as pd

#: files this module can synthesize (relative to the testdata root)
SYNTHESIZED = (
    "adult.csv", "adult_clean.csv", "adult_repair.csv",
    "adult_constraints.txt",
    "hospital.csv", "hospital_constraints.txt",
    "iris.csv",
    "raha/flights.csv", "raha/flights_clean.csv",
)

_MARKER = ".delphi_synth_complete"

ADULT_CONSTRAINTS = (
    't1&EQ(t1.Sex,"Female")&EQ(t1.Relationship,"Husband")\n'
    't1&EQ(t1.Sex,"Male")&EQ(t1.Relationship,"Wife")\n'
)

HOSPITAL_CONSTRAINTS = (
    "t1&t2&EQ(t1.HospitalName,t2.HospitalName)&IQ(t1.ZipCode,t2.ZipCode)\n"
    "t1&t2&EQ(t1.HospitalName,t2.HospitalName)&IQ(t1.City,t2.City)\n"
    "t1&t2&EQ(t1.HospitalName,t2.HospitalName)"
    "&IQ(t1.PhoneNumber,t2.PhoneNumber)\n"
    "t1&t2&EQ(t1.MeasureCode,t2.MeasureCode)&IQ(t1.MeasureName,t2.MeasureName)\n"
    "t1&t2&EQ(t1.ZipCode,t2.ZipCode)&IQ(t1.State,t2.State)\n"
    "t1&t2&EQ(t1.City,t2.City)&IQ(t1.CountyName,t2.CountyName)\n"
)


def adult_tables() -> Dict[str, pd.DataFrame]:
    """The 20-row adult lookalike, its clean version, and the repair
    ground truth. Hand-built (not sampled) because the suite pins it
    cell-by-cell: 7 nulls at fixed positions, Sex histogram 10/7,
    Income 14/4, Relationship->Sex broken only at tids 4 and 11."""
    relationship = ["Husband", "Husband", "Wife", "Wife", "Husband",
                    "Own-child", "Husband", "Husband", "Wife", "Unmarried",
                    "Husband", "Husband", "Husband", "Husband", "Wife",
                    "Own-child", "Husband", "Unmarried", "Husband",
                    "Own-child"]
    sex_clean = ["Male", "Male", "Female", "Female", "Female",
                 "Male", "Male", "Male", "Female", "Female",
                 "Male", "Female", "Male", "Male", "Female",
                 "Male", "Male", "Female", "Male", "Male"]
    age_clean = {"Husband": "31-50", "Wife": "22-30",
                 "Own-child": "18-21", "Unmarried": "22-30"}
    age = [age_clean[r] for r in relationship]
    for t in (4, 10, 16):           # a few older husbands: keeps
        age[t] = ">50"              # Relationship->Age non-deterministic
    education = ["Some-college", "HS-grad", "Bachelors", "HS-grad",
                 "Masters", "HS-grad", "Masters", "Some-college",
                 "Bachelors", "Bachelors", "Masters", "HS-grad",
                 "Some-college", "Bachelors", "HS-grad", "Some-college",
                 "Masters", "HS-grad", "Bachelors", "HS-grad"]
    occupation = ["Exec-managerial", "Craft-repair", "Prof-specialty",
                  "Sales", "Craft-repair", "Student", "Exec-managerial",
                  "Craft-repair", "Prof-specialty", "Sales",
                  "Prof-specialty", "Craft-repair", "Exec-managerial",
                  "Sales", "Prof-specialty", "Student", "Exec-managerial",
                  "Sales", "Exec-managerial", "Student"]
    country = ["United-States"] * 20
    country[9], country[17], country[19] = "India", "India", "Mexico"
    more_than = {0, 6, 10, 13, 16}  # 16 is null in the dirty table
    income = ["MoreThan50K" if t in more_than else "LessThan50K"
              for t in range(20)]

    clean = pd.DataFrame({
        "tid": list(range(20)),
        "Age": age, "Education": education, "Occupation": occupation,
        "Relationship": relationship, "Sex": sex_clean,
        "Country": country, "Income": income,
    })
    dirty = clean.copy()
    null_cells = [(3, "Sex"), (5, "Age"), (5, "Income"), (7, "Sex"),
                  (12, "Age"), (12, "Sex"), (16, "Income")]
    for t, a in null_cells:
        dirty.loc[t, a] = None
    repair = pd.DataFrame(
        [(t, a, clean.loc[t, a]) for t, a in sorted(null_cells)],
        columns=["tid", "attribute", "repaired"])
    return {"adult.csv": dirty, "adult_clean.csv": clean,
            "adult_repair.csv": repair}


def hospital_table(n_hospitals: int = 50, rows_each: int = 20,
                   seed: int = 11) -> pd.DataFrame:
    """1000 x 19(+tid) hospital lookalike: per-hospital FDs
    (name -> city/zip/phone, zip -> state, city -> county,
    measure code -> measure name) with seeded typo violations so the
    reference constraint file detects a non-empty cell set."""
    rng = np.random.RandomState(seed)
    conditions = ["heart attack", "heart failure", "pneumonia",
                  "surgical infection prevention", "children s asthma care"]
    measures = {f"mx-{c[:4].strip()}-{j}": f"measure {c} {j}"
                for c in conditions for j in range(3)}
    mcodes = sorted(measures)
    rows: List[Dict[str, str]] = []
    tid = 0
    for h in range(n_hospitals):
        state = "al" if h % 2 == 0 else "ak"
        zipc = f"{35000 + h:05d}"
        city = f"city{h % 17}"
        base = {
            "ProviderNumber": f"{10000 + h}",
            "HospitalName": f"hospital {h} medical center",
            "Address1": f"{100 + h} main street",
            "Address2": "", "Address3": "",
            "City": city, "State": state, "ZipCode": zipc,
            "CountyName": f"county{h % 17}",
            "PhoneNumber": f"{2050000000 + h * 137:010d}",
            "HospitalType": "acute care hospitals",
            "HospitalOwner": ["government - federal", "proprietary",
                              "voluntary non-profit - private"][h % 3],
            "EmergencyService": "yes" if h % 3 else "no",
        }
        for r in range(rows_each):
            code = mcodes[(h + r) % len(mcodes)]
            cond = conditions[(h + r) % len(conditions)]
            row = dict(base)
            row.update({
                "tid": str(tid),
                "Condition": cond,
                "MeasureCode": code,
                "MeasureName": measures[code],
                "Score": f"{rng.randint(5, 100)}%",
                "Sample": f"{rng.randint(1, 999)} patients",
                "Stateavg": f"{state}_{code}",
            })
            rows.append(row)
            tid += 1
    df = pd.DataFrame(rows)
    df = df[["tid", "ProviderNumber", "HospitalName", "Address1",
             "Address2", "Address3", "City", "State", "ZipCode",
             "CountyName", "PhoneNumber", "HospitalType", "HospitalOwner",
             "EmergencyService", "Condition", "MeasureCode", "MeasureName",
             "Score", "Sample", "Stateavg"]]
    # seeded corruption: FD-violating typos + a few blanks, ~2% of rows
    bad = rng.choice(len(df), size=24, replace=False)
    for k, i in enumerate(sorted(bad)):
        col = ["City", "ZipCode", "PhoneNumber", "MeasureName",
               "State", "CountyName"][k % 6]
        v = str(df.iloc[i, df.columns.get_loc(col)])
        df.iloc[i, df.columns.get_loc(col)] = \
            ("x" + v[1:]) if v else "x"
    blanks = rng.choice(len(df), size=8, replace=False)
    for i in blanks:
        df.iloc[i, df.columns.get_loc("Score")] = np.nan
    return df


def iris_table(seed: int = 5) -> pd.DataFrame:
    """150-row iris lookalike: four numeric columns clustered by species
    (so numeric repairs have signal) plus a handful of planted nulls for
    the CLI chunked-vs-whole repair comparison."""
    rng = np.random.RandomState(seed)
    parts = []
    centers = {
        "setosa": (5.0, 3.4, 1.5, 0.2),
        "versicolor": (5.9, 2.8, 4.3, 1.3),
        "virginica": (6.6, 3.0, 5.6, 2.0),
    }
    for species, (sl, sw, pl, pw) in centers.items():
        parts.append(pd.DataFrame({
            "sepal_length": np.round(rng.normal(sl, 0.3, 50), 1),
            "sepal_width": np.round(rng.normal(sw, 0.3, 50), 1),
            "petal_length": np.round(rng.normal(pl, 0.4, 50), 1),
            "petal_width": np.round(rng.normal(pw, 0.2, 50), 1),
            "species": species,
        }))
    df = pd.concat(parts, ignore_index=True)
    df.insert(0, "tid", range(len(df)))
    for i, col in ((7, "sepal_length"), (31, "sepal_width"),
                   (64, "petal_length"), (88, "petal_width"),
                   (112, "sepal_length"), (140, "petal_width")):
        df.loc[i, col] = np.nan
    return df


def flights_tables(n_rows: int = 2376, seed: int = 3) \
        -> Dict[str, pd.DataFrame]:
    """raha-layout flights lookalike: a wide dirty table keyed by
    ``tuple_id`` where the times are functions of the flight number, plus
    the long-format clean truth (``tuple_id, attribute, correct_val``)
    covering every cell, exactly how ``bench.flights`` consumes it."""
    rng = np.random.RandomState(seed)
    flight = rng.randint(0, 180, size=n_rows)
    clean = pd.DataFrame({
        "tuple_id": [str(i + 1) for i in range(n_rows)],
        "src": [f"src{i % 5}" for i in flight],
        "flight": [f"fl-{i:04d}" for i in flight],
        "sched_dep_time": [f"{6 + i % 16}:{(i * 7) % 60:02d}"
                           for i in flight],
        "act_dep_time": [f"{6 + i % 16}:{(i * 7 + 9) % 60:02d}"
                         for i in flight],
        "sched_arr_time": [f"{8 + i % 14}:{(i * 11) % 60:02d}"
                           for i in flight],
    })
    dirty = clean.copy()
    attrs = ["sched_dep_time", "act_dep_time", "sched_arr_time"]
    bad = rng.choice(n_rows, size=int(0.18 * n_rows), replace=False)
    for i in sorted(bad):
        col = attrs[i % len(attrs)]
        kind = i % 3
        v = clean.iloc[i, clean.columns.get_loc(col)]
        if kind == 0:
            dirty.iloc[i, dirty.columns.get_loc(col)] = None
        elif kind == 1:
            dirty.iloc[i, dirty.columns.get_loc(col)] = v.replace(":", ".")
        else:
            donor = int(rng.randint(n_rows))
            dirty.iloc[i, dirty.columns.get_loc(col)] = \
                clean.iloc[donor, clean.columns.get_loc(col)]
    truth = clean.melt(id_vars=["tuple_id"], var_name="attribute",
                       value_name="correct_val")
    return {"raha/flights.csv": dirty, "raha/flights_clean.csv": truth}


def _atomic_write(path: str, write_fn) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path),
                               prefix=".synth_tmp_")
    try:
        with os.fdopen(fd, "w") as f:
            write_fn(f)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def default_root() -> str:
    """Stable per-user materialization directory (overridable for tests
    via an explicit ``materialize_testdata(root)`` argument)."""
    base = tempfile.gettempdir()
    return os.path.join(base, f"delphi_synth_testdata_{os.getuid()}")


def materialize_testdata(root: str = "") -> str:
    """Writes every synthesizable testdata file under ``root`` (atomic
    per-file, idempotent via a completion marker) and returns the root.
    Safe under concurrent callers: files land via ``os.replace`` and the
    marker is written last."""
    root = root or default_root()
    marker = os.path.join(root, _MARKER)
    if os.path.exists(marker):
        return root
    frames: Dict[str, pd.DataFrame] = {}
    frames.update(adult_tables())
    frames["hospital.csv"] = hospital_table()
    frames["iris.csv"] = iris_table()
    frames.update(flights_tables())
    for rel, df in frames.items():
        _atomic_write(os.path.join(root, rel),
                      lambda f, df=df: df.to_csv(f, index=False))
    _atomic_write(os.path.join(root, "adult_constraints.txt"),
                  lambda f: f.write(ADULT_CONSTRAINTS))
    _atomic_write(os.path.join(root, "hospital_constraints.txt"),
                  lambda f: f.write(HOSPITAL_CONSTRAINTS))
    _atomic_write(marker, lambda f: f.write("ok\n"))
    return root
