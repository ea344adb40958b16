"""The port's DataVec (``deeplearning4j_tpu_torch/datavec/``) against the JAX
package's, on the CPU.

Both packages are host Python and numpy here, so the comparisons are exact:
records equal value for value and type for type (an int stays an int, NaN
matches NaN), schemas equal as dicts, ``to_json`` equal byte for byte and
each package's JSON loading in the other, iterator batches equal bit for
bit with their dtypes. The cases of ``tests/test_datavec.py`` that need no
scikit-learn run through both packages. The ETL of
``examples/datavec_etl.py`` feeds both packages' nets from the same
weights (``load_jax_params``): 5 ``fit_batch`` losses within ``TOL_LOSS``.
"""

import json
import math
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import deeplearning4j_tpu.datavec as J
import deeplearning4j_tpu_torch.datavec as T

TOL_LOSS = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One PyTorch intra-op thread for this file's tests: tier-1 runs six
    workers over the machine's cores, and at the default pool size their
    OpenMP threads oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def same(a, b, where="") -> None:
    """``a`` and ``b`` equal value for value and type for type (NaN equal
    to NaN, numpy arrays equal bit for bit with their dtype)."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        assert isinstance(a, np.ndarray) and isinstance(b, np.ndarray), where
        assert a.dtype == b.dtype and a.shape == b.shape, where
        np.testing.assert_array_equal(a, b, err_msg=where)
        return
    assert type(a) is type(b), (where, a, b)
    if isinstance(a, (list, tuple)):
        assert len(a) == len(b), (where, a, b)
        for i, (x, y) in enumerate(zip(a, b)):
            same(x, y, f"{where}[{i}]")
    elif isinstance(a, dict):
        assert list(a) == list(b), (where, a, b)
        for k in a:
            same(a[k], b[k], f"{where}[{k!r}]")
    elif isinstance(a, float) and math.isnan(a):
        assert math.isnan(b), (where, a, b)
    else:
        assert a == b, (where, a, b)


def both(fn):
    """``fn(J)`` and ``fn(T)``, held equal; returns the port's."""
    want, got = fn(J), fn(T)
    same(got, want)
    return got


def test_exports_equal_the_jax_all():
    assert T.__all__ == J.__all__ and len(T.__all__) == 23
    for name in T.__all__:
        assert getattr(T, name).__name__ == getattr(J, name).__name__


# ------------------------------------------------------------------ readers

def test_csv_reader_with_header(tmp_path):
    f = tmp_path / "data.csv"
    f.write_text("a,b,c,d\n1,2.5,x,-3\n3,4.5,y,1e3\n\n5,,z,07\n")
    rows = both(lambda P: [list(P.CSVRecordReader(f, skip_lines=1)),
                           list(P.CSVRecordReader(text=f.read_text()))])
    assert rows[0][0] == [1, 2.5, "x", -3]


def test_csv_reader_delimiter_and_reset():
    text = "1;2\n3;4\n"

    def run(P):
        rr = P.CSVRecordReader(text=text, delimiter=";")
        first = list(rr)
        return first, list(rr), rr.has_next()
    both(run)


def test_line_reader(tmp_path):
    f = tmp_path / "t.txt"
    f.write_text("hello\nworld, again\n\nlast")
    both(lambda P: list(P.LineRecordReader(f)))


def test_csv_sequence_reader(tmp_path):
    (tmp_path / "s2.csv").write_text("h,h\n5,6\n")
    (tmp_path / "s1.csv").write_text("h,h\n1,2.5\n3,x\n")
    (tmp_path / "notes.txt").write_text("skipped")
    seqs = both(lambda P: list(P.CSVSequenceRecordReader(tmp_path,
                                                         skip_lines=1)))
    assert seqs == [[[1, 2.5], [3, "x"]], [[5, 6]]]


def test_collection_reader_copies_records():
    recs = [[1, "a"], [2, "b"]]

    def run(P):
        rr = P.CollectionRecordReader(recs)
        out = list(rr)
        out[0].append("mutated")
        return list(rr)
    assert both(run) == recs


@pytest.mark.parametrize("shape,hw,channels", [
    ((8, 6), (4, 4), 3),          # gray [H, W] repeated to RGB, resized
    ((5, 7, 1), (9, 3), 3),       # gray [H, W, 1], upsampled
    ((6, 6, 3), (6, 6), 3),       # no resize
    ((10, 12, 3), None, 3),       # no target size
    ((8, 8), (4, 4), 1),          # one channel kept
])
def test_image_reader(tmp_path, shape, hw, channels):
    rng = np.random.default_rng(3)
    for cls in ("dog", "cat", "eel"):
        d = tmp_path / cls
        d.mkdir()
        for i in range(3):
            np.save(d / f"{i}.npy",
                    rng.integers(0, 256, shape).astype(np.uint8))
    (tmp_path / "empty").mkdir()
    h, w = hw if hw else (None, None)

    def run(P):
        rr = P.ImageRecordReader(tmp_path, h, w, channels)
        return rr.labels, list(rr)
    labels, recs = both(run)
    assert labels == ["cat", "dog", "eel", "empty"] and len(recs) == 9
    assert recs[0][0].dtype == np.float32


def test_image_reader_needs_both_sides(tmp_path):
    for P in (J, T):
        with pytest.raises(ValueError, match="both height and width"):
            P.ImageRecordReader(tmp_path, height=4)


def test_numeric_array_python_rows(tmp_path):
    f = tmp_path / "n.csv"
    f.write_text("# comment\nh1,h2\n1,2\n3.5,4\n")
    # two skipped lines: the Python rows, no native parser
    both(lambda P: P.CSVRecordReader(f, skip_lines=2).numeric_array())


# --------------------------------------------------------------- transforms

def _schema(P):
    return (P.Schema.builder()
            .add_column_string("key")
            .add_column_integer("n")
            .add_column_double("v")
            .add_column_categorical("state", "CA", "NY", "TX")
            .add_column_integer("k")
            .add_column_string("ts")
            .build())


RECS = [
    ["a", -7, 1.5, "NY", 0, "2019-06-03 13:30:00"],
    ["b", 7, -0.25, "CA", 2, "2019-06-09 00:00:00"],
    ["a", 3, 4.0, "TX", 1, "2020-02-29 23:59:59"],
    ["c", 0, 2.0, "CA", 1, "2019-12-31 12:00:00"],
    ["a", 1, -3.0, "NY", 2, "1999-01-01 06:07:08"],
]
BAD = [
    ["a", 1, "", "NY", 0, "x"],
    ["b", 2, float("nan"), "??", 1, "y"],
    ["c", 3, "oops", "", 2, ""],
    ["d", 4, 0.5, "TX", 0, "z"],
]
TIME = "%Y-%m-%d %H:%M:%S"

# name -> (builder steps, records); P is the package, b its builder
STEPS = {
    "remove_columns": (lambda P, b: b.remove_columns("ts", "k"), RECS),
    "remove_all_columns_except": (
        lambda P, b: b.remove_all_columns_except("v", "key"), RECS),
    "rename_column": (lambda P, b: b.rename_column("v", "value"), RECS),
    "duplicate_column": (lambda P, b: b.duplicate_column("state", "s2"),
                         RECS),
    "add_constant_column": (
        lambda P, b: b.add_constant_column("one", "integer", 1)
        .add_constant_column("w", "double", 0.5), RECS),
    "condition_filter_lt": (
        lambda P, b: b.condition_filter(P.less_than("n", 0)), RECS),
    "condition_filter_boolean": (
        lambda P, b: b.condition_filter(
            P.equal_to("state", "CA") | P.greater_than("n", 2)), RECS),
    "condition_filter_not_in_set": (
        lambda P, b: b.condition_filter(~P.in_set("key", ["a"])), RECS),
    "condition_filter_and_ops": (
        lambda P, b: b.condition_filter(
            P.ColumnCondition("v", "gte", 1.5)
            & P.ColumnCondition("k", "neq", 2)
            & P.ColumnCondition("n", "lte", 3)), RECS),
    "condition_filter_not_in_set_op": (
        lambda P, b: b.condition_filter(
            P.ColumnCondition("state", "not_in_set", ("CA", "TX"))), RECS),
    "conditional_replace_value": (
        lambda P, b: b.conditional_replace_value(
            "v", 9.0, P.less_than("v", 0.0)), RECS),
    "replace_invalid_numeric": (
        lambda P, b: b.replace_invalid_with("v", 0.0), BAD),
    "replace_invalid_categorical": (
        lambda P, b: b.replace_invalid_with("state", "CA"), BAD),
    "replace_invalid_string": (
        lambda P, b: b.replace_invalid_with("ts", "none"), BAD),
    "filter_is_invalid": (
        lambda P, b: b.condition_filter(P.is_invalid("v")), BAD),
    "categorical_to_integer": (
        lambda P, b: b.categorical_to_integer("state"), RECS),
    "integer_to_categorical": (
        lambda P, b: b.integer_to_categorical("k", "zero", "one", "two"),
        RECS),
    "categorical_to_one_hot": (
        lambda P, b: b.categorical_to_one_hot("state"), RECS),
    "string_to_categorical": (
        lambda P, b: b.string_to_categorical("key", "a", "b", "c")
        .categorical_to_one_hot("key"), RECS),
    "string_ops": (
        lambda P, b: b.change_case("key", "upper").append_string("key", "!")
        .replace_string("key", "A", "Z").change_case("key", "lower")
        .concat_columns("tag", "-", "key", "n", "v"), RECS),
    "double_math_ops": (
        lambda P, b: b.double_math_op("v", "add", 1.0)
        .double_math_op("v", "subtract", 0.25)
        .double_math_op("v", "multiply", 3.0)
        .double_math_op("v", "divide", 7.0)
        .double_math_op("v", "pow", 2.0), RECS),
    "integer_math_add_mul": (
        lambda P, b: b.integer_math_op("n", "add", 5)
        .integer_math_op("n", "subtract", 2)
        .integer_math_op("n", "multiply", 3), RECS),
    "integer_math_divide_java": (
        lambda P, b: b.integer_math_op("n", "divide", 2), RECS),
    "integer_math_modulus_java": (
        lambda P, b: b.integer_math_op("n", "modulus", 3), RECS),
    "double_columns_math_ops": (
        lambda P, b: b.double_columns_math_op("s", "add", "v", "n", "k")
        .double_columns_math_op("d", "subtract", "v", "n")
        .double_columns_math_op("p", "multiply", "v", "k")
        .double_columns_math_op("q", "divide", "n", "v"), RECS),
    "normalize_min_max": (
        lambda P, b: b.normalize_min_max("v", -3.0, 4.0)
        .normalize_min_max("n", 2.0, 2.0), RECS),
    "time_fields_joda_utc": (
        lambda P, b: b.string_to_time("ts", TIME)
        .derive_column_from_time("ts", "h", "hour_of_day")
        .derive_column_from_time("ts", "dow", "day_of_week")
        .derive_column_from_time("ts", "dom", "day_of_month")
        .derive_column_from_time("ts", "m", "month")
        .derive_column_from_time("ts", "y", "year"), RECS),
    "reduce_per_column_ops": (
        lambda P, b: b.reduce(
            P.Reducer.builder("key").min_columns("n").max_columns("v")
            .sum_columns("k").build()), RECS),
    "reduce_mean_stdev_counts": (
        lambda P, b: b.reduce(
            P.Reducer.builder("key").mean_columns("v").stdev_columns("n")
            .count_columns("state").count_unique_columns("k").build()),
        RECS),
    "reduce_take_and_default": (
        lambda P, b: b.reduce(
            P.Reducer.builder("key").default_op("take_last")
            .take_first_columns("state").build()), RECS),
    "reduce_invalid_values": (
        lambda P, b: b.reduce(
            P.Reducer.builder("key").default_op("sum")
            .take_first_columns("state").count_columns("ts").build()),
        BAD),
    "convert_to_sequence": (
        lambda P, b: b.convert_to_sequence("key", "n"), RECS),
    "record_steps_inside_sequences": (
        lambda P, b: b.convert_to_sequence("key", "n")
        .double_math_op("v", "multiply", 10.0)
        .condition_filter(P.equal_to("state", "TX"))
        .convert_from_sequence(), RECS),
    "offset_sequence_next_step": (
        lambda P, b: b.duplicate_column("v", "target")
        .convert_to_sequence("key", "n")
        .offset_sequence(["target"], -1), RECS),
    "offset_sequence_positive": (
        lambda P, b: b.convert_to_sequence("key", "k")
        .offset_sequence(["v", "n"], 1), RECS),
    "trim_sequence": (
        lambda P, b: b.convert_to_sequence("key", "n").trim_sequence(1),
        RECS),
    "trim_sequence_from_end": (
        lambda P, b: b.convert_to_sequence("key", "n")
        .trim_sequence(1, from_first=False), RECS),
    "split_sequence_by_length": (
        lambda P, b: b.convert_to_sequence("state", "n")
        .split_sequence_by_length(1), RECS),
}


def _process(P, name):
    steps, _ = STEPS[name]
    return steps(P, P.TransformProcess.builder(_schema(P))).build()


@pytest.mark.parametrize("name", sorted(STEPS))
def test_transform_step(name):
    records = STEPS[name][1]

    def run(P):
        tp = _process(P, name)
        return (tp.execute([list(r) for r in records]),
                tp.final_schema().to_dict(), tp.to_json())
    out, schema, js = both(run)
    assert out, "the case must keep some records"
    # each package's JSON loads in the other and runs the same
    for P in (J, T):
        tp2 = P.TransformProcess.from_json(js)
        same(tp2.execute([list(r) for r in records]), out, P.__name__)
        assert tp2.to_json() == js


def test_transform_json_text_is_the_jax_text():
    """A process with conditions, a reducer and sequence steps: the JSON
    text itself, not only its parse, is the JAX package's."""
    def run(P):
        tp = (P.TransformProcess.builder(_schema(P))
              .condition_filter(P.less_than("v", -1.0)
                                | ~P.in_set("state", {"CA", "NY"}))
              .conditional_replace_value("v", 9.0, P.is_invalid("v"))
              .categorical_to_integer("state")
              .reduce(P.Reducer.builder("key", "k").sum_columns("v")
                      .take_first_columns("state").build())
              .build())
        return tp.to_json()
    js = both(run)
    assert json.loads(js)["steps"][3]["op"] == "reduce"


def test_sequence_input_execute():
    seqs = [[["a", 1, 1.0, "CA", 0, "x"], ["a", 2, 2.0, "NY", 1, "y"]],
            [["b", 1, 5.0, "TX", 2, "z"]]]
    both(lambda P: P.TransformProcess.builder(_schema(P))
         .double_math_op("v", "add", 1.0).trim_sequence(1).build()
         .execute(seqs, sequences=True))


@pytest.mark.parametrize("build", [
    lambda P, b: b.split_sequence_by_length(1),
    lambda P, b: b.offset_sequence(["v"], 1),
    lambda P, b: b.convert_to_sequence("key", "n").reduce(
        P.Reducer.builder("key").sum_columns("v").build()),
], ids=["sequence_global", "sequence_step", "flat_global"])
def test_mode_guards(build):
    def run(P):
        tp = build(P, P.TransformProcess.builder(_schema(P))).build()
        with pytest.raises(ValueError) as e:
            tp.execute([list(r) for r in RECS])
        return str(e.value)
    assert "mode" in both(run)


def test_raw_callables_run_and_refuse_json():
    def run(P):
        tp = (P.TransformProcess.builder(_schema(P))
              .filter(lambda s, r: r[s.index_of("n")] > 0)
              .double_map("v", lambda x: x * x + 1.0).build())
        with pytest.raises(ValueError) as e:
            tp.to_json()
        return tp.execute([list(r) for r in RECS]), str(e.value)
    both(run)


def test_conditions_check():
    def run(P):
        s = _schema(P)
        conds = [P.less_than("v", 3.0), P.greater_than("n", 0),
                 P.equal_to("state", "NY"), P.equal_to("n", "3"),
                 P.in_set("state", ["CA", "NY"]), P.is_invalid("v"),
                 P.is_invalid("state"), P.is_invalid("key"),
                 P.greater_than("n", 0) & ~P.equal_to("key", "a")]
        return [[c.check(s, r) for c in conds] for r in RECS + BAD]
    both(run)


def test_unknown_ops_refused():
    for P in (J, T):
        with pytest.raises(ValueError, match="unknown condition op"):
            P.ColumnCondition("v", "approx", 1.0)
        with pytest.raises(ValueError, match="unknown reduce op"):
            P.Reducer(["key"], "median", {})
        with pytest.raises(ValueError, match="unknown time field"):
            (P.TransformProcess.builder(_schema(P))
             .derive_column_from_time("ts", "q", "quarter"))
        with pytest.raises(ValueError, match="join type"):
            P.Join("cross", _schema(P), _schema(P), ["key"])


def test_reducer_alone():
    def run(P):
        red = (P.Reducer.builder("key").stdev_columns("v")
               .count_unique_columns("k").build())
        return (red.reduce(_schema(P), [list(r) for r in RECS]),
                red.output_schema(_schema(P)).to_dict())
    both(run)


@pytest.mark.parametrize("kind", ["inner", "left_outer", "right_outer",
                                  "full_outer"])
def test_join(kind):
    lrec = [[1, "a"], [2, "b"], [3, "c"], [3, "c2"]]
    rrec = [[1, 0.5], [3, 0.7], [4, 0.9], [1, 0.6]]

    def run(P):
        left = (P.Schema.builder().add_column_integer("id")
                .add_column_string("name").build())
        right = (P.Schema.builder().add_column_integer("id")
                 .add_column_double("score").build())
        j = (P.Join.builder(kind).set_schemas(left, right).set_keys("id")
             .build())
        return j.execute(lrec, rrec), j.output_schema().to_dict()
    both(run)


def test_analyze():
    def run(P):
        da = P.analyze(_schema(P), [list(r) for r in RECS + BAD])
        cols = ("key", "n", "v", "state", "k", "ts")
        return ([repr(da.column_analysis(c)) for c in cols],
                [vars(da.column_analysis(c)) for c in cols], repr(da))
    both(run)


# ---------------------------------------------------------------- iterators

def test_record_iterator_classification():
    records = [[0.1, 0.2, 0], [0.3, 0.4, 1], [0.5, 0.6, 2], [0.7, 0.8, 0],
               [0.9, 1.0, 1]]

    def run(P):
        it = P.RecordReaderDataSetIterator(P.CollectionRecordReader(records),
                                           batch_size=2, num_classes=3)
        first = [vars(ds) for ds in it]
        return first, [vars(ds) for ds in it]
    first, second = both(run)
    assert len(first) == 3
    same(second, first)      # the second epoch after the implicit reset


@pytest.mark.parametrize("label_index,regression", [(0, True), (1, False)])
def test_record_iterator_label_index(label_index, regression):
    records = [[1, 0, 2.5], [0, 1, 3.5], [1, 1, 4.5]]

    def run(P):
        it = P.RecordReaderDataSetIterator(
            P.CollectionRecordReader(records), batch_size=2,
            label_index=label_index, regression=regression,
            num_classes=None if regression else 2)
        return [vars(ds) for ds in it]
    both(run)


def test_record_iterator_needs_num_classes():
    for P in (J, T):
        with pytest.raises(ValueError, match="num_classes"):
            P.RecordReaderDataSetIterator(P.CollectionRecordReader([]), 2)
        with pytest.raises(ValueError, match="num_classes"):
            P.SequenceRecordReaderDataSetIterator(
                P.CollectionRecordReader([]), 2)


def test_image_iterator(tmp_path):
    rng = np.random.default_rng(5)
    for ci, cls in enumerate(("b", "a")):
        d = tmp_path / cls
        d.mkdir()
        for i in range(3):
            np.save(d / f"{i}.npy",
                    rng.integers(0, 256, (7, 5, 3)).astype(np.uint8))

    def run(P):
        it = P.RecordReaderDataSetIterator(
            P.ImageRecordReader(tmp_path, 4, 6, 3), batch_size=4,
            num_classes=2)
        return [vars(ds) for ds in it]
    out = both(run)
    assert out[0]["features"].shape == (4, 4, 6, 3)


SEQS = [
    [[0.1, 0.2, 0], [0.3, 0.4, 1], [0.5, 0.6, 2]],
    [[0.7, 0.8, 1]],
    [[0.9, 1.0, 2], [1.1, 1.2, 0]],
]


@pytest.mark.parametrize("align", ["start", "end"])
@pytest.mark.parametrize("regression", [False, True])
def test_sequence_iterator(align, regression):
    def run(P):
        it = P.SequenceRecordReaderDataSetIterator(
            P.CollectionRecordReader(SEQS), batch_size=2,
            num_classes=None if regression else 3, regression=regression,
            align=align)
        return [vars(ds) for ds in it]
    out = both(run)
    assert out[0]["features_mask"] is not None and len(out) == 2


def test_sequence_iterator_label_index_zero():
    seqs = [[[1, 0.5, 0.25], [0, 0.7, 0.5]], [[1, 0.1, 0.2]]]
    both(lambda P: [vars(ds) for ds in P.SequenceRecordReaderDataSetIterator(
        P.CollectionRecordReader(seqs), batch_size=2, label_index=0,
        num_classes=2)])


def test_sequence_iterator_over_csv_sequences(tmp_path):
    (tmp_path / "a.csv").write_text("1,2,0\n3,4,1\n")
    (tmp_path / "b.csv").write_text("5,6,1\n")
    both(lambda P: [vars(ds) for ds in P.SequenceRecordReaderDataSetIterator(
        P.CSVSequenceRecordReader(tmp_path), batch_size=4, num_classes=2,
        align="end")])


def test_sequence_iterator_bad_align():
    for P in (J, T):
        with pytest.raises(ValueError, match="align"):
            P.SequenceRecordReaderDataSetIterator(
                P.CollectionRecordReader([]), 2, num_classes=2,
                align="middle")


def test_iterators_yield_the_ports_dataset():
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet

    ds = next(iter(T.SequenceRecordReaderDataSetIterator(
        T.CollectionRecordReader(SEQS), 2, num_classes=3)))
    assert type(ds) is DataSet and isinstance(ds.features, np.ndarray)


# ------------------------------------------------ the ETL example, end to end

def _etl(P, path):
    """``examples/datavec_etl.py``'s process, read and executed by ``P``."""
    schema = (P.Schema.builder().add_column_double("x")
              .add_column_double("y")
              .add_column_categorical("label", "A", "B", "C").build())
    tp = (P.TransformProcess.builder(schema)
          .replace_invalid_with("x", 0.0)
          .condition_filter(P.less_than("y", -9.0))
          .categorical_to_integer("label").build())
    tp = P.TransformProcess.from_json(tp.to_json())
    records = tp.execute(list(P.CSVRecordReader(path)))
    means = (P.Reducer.builder("label").mean_columns("x", "y").build()
             .reduce(tp.final_schema(), records))
    it = P.RecordReaderDataSetIterator(P.CollectionRecordReader(records),
                                       batch_size=64, label_index=2,
                                       num_classes=3)
    return (records, means, repr(P.analyze(tp.final_schema(), records)),
            [vars(ds) for ds in it])


def test_etl_example_trains_both_packages_alike(tmp_path):
    import sys

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent
                           / "examples"))
    try:
        from datavec_etl import make_csv
    finally:
        sys.path.pop(0)
    make_csv(tmp_path / "data.csv", 300)
    _, _, _, batches = both(lambda P: _etl(P, tmp_path / "data.csv"))

    from deeplearning4j_tpu.nn import (InputType as JIT,
                                       MultiLayerNetwork as JMLN,
                                       NeuralNetConfiguration as JNNC)
    from deeplearning4j_tpu.nn.layers import (DenseLayer as JDense,
                                              OutputLayer as JOut)
    from deeplearning4j_tpu.optimize import Adam as JAdam
    from deeplearning4j_tpu_torch.nn.conf.builders import (
        MultiLayerConfiguration)
    from deeplearning4j_tpu_torch.nn.multilayer import (MultiLayerNetwork,
                                                        load_jax_params)

    jnet = JMLN(JNNC.builder().seed(7).updater(JAdam(lr=1e-2)).list()
                .layer(JDense(n_out=32, activation="relu"))
                .layer(JOut(n_out=3, activation="softmax", loss="mcxent"))
                .set_input_type(JIT.feed_forward(2)).build()).init()
    net = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        jnet.conf.to_json())).init(device="cpu")
    load_jax_params(net, jax.tree_util.tree_map(np.asarray, jnet.params))
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for step in range(5):
            b = batches[step % len(batches)]
            want = float(jnet.fit_batch((b["features"], b["labels"])))
            got = float(net.fit_batch((b["features"], b["labels"])))
            assert abs(got - want) <= TOL_LOSS, (step, got, want)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
