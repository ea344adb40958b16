"""Port's session journal against the JAX package, and resume exactness.

The journal's ndjson records are the JAX package's field for field: a
journal written by either package replays in the other, with the same
records, tallies, torn-tail and sequence-gap verdicts. Within the port, a
session interrupted at several points (one past a KV ring wrap) and
resumed into a new engine through a new journal continues token for token
(sampled decoding: the sampler draws from (seed, position)). A session the
JAX engine journaled and the port resumes, greedy, ends as the JAX
package's uninterrupted run.
"""

import json

import jax
import numpy as np
import pytest

from deeplearning4j_tpu.generation import GenerationEngine as JaxEngine
from deeplearning4j_tpu.generation import SessionJournal as JaxJournal
from deeplearning4j_tpu.nn.conf.builders import NeuralNetConfiguration as JaxNNC
from deeplearning4j_tpu.nn.conf.inputs import InputType as JaxInputType
from deeplearning4j_tpu.nn.layers import LSTMLayer as JaxLSTM
from deeplearning4j_tpu.nn.layers import RnnOutputLayer as JaxRnnOut
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxNet
from deeplearning4j_tpu_torch.generation import (
    AttentionDecodeAdapter, GenerationEngine, SessionJournal,
)
from deeplearning4j_tpu_torch.nn.conf.builders import (
    MultiLayerConfiguration, NeuralNetConfiguration,
)
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.layers import (
    EmbeddingSequenceLayer, LSTMLayer, RnnOutputLayer,
)
from deeplearning4j_tpu_torch.nn.layers.attention import (
    PositionalEmbeddingLayer, TransformerEncoderLayer,
)
from deeplearning4j_tpu_torch.nn.multilayer import (
    MultiLayerNetwork, load_jax_params,
)

V = 13
SAMPLER = dict(max_new_tokens=12, temperature=0.9, seed=11)


@pytest.fixture(scope="module")
def lstm_net():
    conf = (NeuralNetConfiguration.builder().seed(7).list()
            .layer(LSTMLayer(n_out=12))
            .layer(RnnOutputLayer(n_out=V, activation="softmax",
                                  loss="mcxent"))
            .set_input_type(InputType.recurrent(V, 8)).build())
    return MultiLayerNetwork(conf).init(device="cpu")


@pytest.fixture(scope="module")
def ring_net():
    """One transformer layer: K/V entries are position-local, so a resume
    whose prefill refills the wrapped ring reproduces the ring exactly."""
    conf = (NeuralNetConfiguration.builder().seed(5).list()
            .layer(EmbeddingSequenceLayer(n_out=16, n_in=V))
            .layer(PositionalEmbeddingLayer(max_len=32))
            .layer(TransformerEncoderLayer(d_model=16, n_heads=2,
                                           causal=True))
            .layer(RnnOutputLayer(n_out=V, activation="softmax",
                                  loss="mcxent"))
            .set_input_type(InputType.recurrent(V, 12)).build())
    return MultiLayerNetwork(conf).init(device="cpu")


class _Req:
    def __init__(self, prompt, max_new, temp=0.5, seed=3):
        self.prompt, self.max_new_tokens = tuple(prompt), max_new
        self.temperature, self.top_k, self.top_p = temp, 0, 1.0
        self.seed, self.eos_id = seed, None


class _Stream:
    def __init__(self, rid, req):
        self.request_id, self.request, self.seq0 = rid, req, 0


def _script(journal_cls, path):
    """The same session events through either package's journal: one
    finished session, one preempted (left open), one cancelled."""
    j = journal_cls(path)
    a = _Stream("a", _Req((1, 2), 4))
    b = _Stream("b", _Req((3,), 8, temp=0.0, seed=0))
    c = _Stream("c", _Req((4, 5, 6), 3))
    for s in (a, b, c):
        j.attach(s, klass="batch" if s is c else None)
    for tok in (7, 8):
        j.emitted(a, tok)
        j.emitted(b, tok + 2)
    j.emitted(c, 1)
    j.finished(a, "length")
    j.finished(b, "preempted")
    j.finished(c, "cancelled")
    j.close()


def _records(j):
    return {rid: (r.prompt, r.tokens, r.finish_reason, r.corrupt, r.klass,
                  r.seed, r.temperature, r.resumes)
            for rid, r in j._records.items()}


def _lines(path):
    with open(path) as f:
        return [json.loads(x) for x in f if x.strip()]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_journal_replays_across_packages(tmp_path, writer):
    p = str(tmp_path / "j.ndjson")
    _script(JaxJournal if writer == "jax" else SessionJournal, p)
    mine, theirs = SessionJournal(p), JaxJournal(p)
    assert _records(mine) == _records(theirs)
    assert [r.request_id for r in mine.interrupted()] == ["b"]
    assert mine.get("b").tokens == [9, 10]
    assert mine.describe() == dict(theirs.describe(), path=p)
    mine.close()
    theirs.close()


def test_journal_lines_match_jax_field_for_field(tmp_path):
    pj, pp = str(tmp_path / "jax.ndjson"), str(tmp_path / "port.ndjson")
    _script(JaxJournal, pj)
    _script(SessionJournal, pp)
    drop_t = lambda ev: {k: v for k, v in ev.items() if k != "t"}
    assert [drop_t(e) for e in _lines(pp)] == [drop_t(e) for e in _lines(pj)]
    assert [list(e) for e in _lines(pp)] == [list(e) for e in _lines(pj)]


def test_seq_gap_and_unknown_id_mark_corrupt(tmp_path):
    p = str(tmp_path / "j.ndjson")
    with open(p, "w") as f:
        f.write('{"e":"open","id":"a","prompt":[1],"max_new":8,'
                '"temp":0.0,"top_k":0,"top_p":1.0,"seed":0}\n')
        f.write('{"e":"tok","id":"a","seq":1,"tok":4}\n')
        f.write('{"e":"tok","id":"a","seq":3,"tok":6}\n')   # 2 lost
        f.write('{"e":"tok","id":"ghost","seq":1,"tok":4}\n')
    for cls in (SessionJournal, JaxJournal):
        j = cls(p)
        assert j.get("a").corrupt and j.get("ghost").corrupt
        assert j.interrupted() == []
        j.close()


def test_torn_tail_taints_open_sessions_only(tmp_path):
    p = str(tmp_path / "j.ndjson")
    with open(p, "w") as f:
        f.write('{"e":"open","id":"done","prompt":[1],"max_new":1,'
                '"temp":0.0,"top_k":0,"top_p":1.0,"seed":0}\n')
        f.write('{"e":"tok","id":"done","seq":1,"tok":4}\n')
        f.write('{"e":"fin","id":"done","reason":"length"}\n')
        f.write('{"e":"open","id":"live","prompt":[2],"max_new":8,'
                '"temp":0.0,"top_k":0,"top_p":1.0,"seed":0}\n')
        f.write('{"e":"tok","id":"live","seq":1,"tok"')    # torn write
    j = SessionJournal(p)
    assert j.get("done").finish_reason == "length"
    assert not j.get("done").corrupt
    assert j.get("live").corrupt
    assert j.interrupted() == [] and j.corrupt_lines == 1
    j.close()


# --------------------------------------------------------- resume exactness
def _kill(eng, steps):
    for _ in range(steps):
        eng.step()
    eng.shutdown(timeout=0, reason="preempted")
    eng.journal.close()


@pytest.mark.parametrize("kill_after", [1, 4, 9])
def test_lstm_kill_and_resume_bit_identical(lstm_net, tmp_path, kill_after):
    ref = GenerationEngine(lstm_net, slots=4, max_len=64,
                           device="cpu").generate([1, 2, 3], **SAMPLER)
    assert len(ref) == SAMPLER["max_new_tokens"]
    p = str(tmp_path / "j.ndjson")
    eng = GenerationEngine(lstm_net, slots=4, max_len=64, device="cpu",
                           journal=SessionJournal(p))
    eng.submit([1, 2, 3], request_id="r1", **SAMPLER)
    _kill(eng, kill_after)
    j2 = SessionJournal(p)
    eng2 = GenerationEngine(lstm_net, slots=4, max_len=64, device="cpu")
    eng2.attach_journal(j2)
    assert j2.resume_into(eng2) == {"resumed": 1, "lost": 0, "completed": 0}
    eng2.drain()
    rec = j2.get("r1")
    assert rec.finish_reason == "length" and rec.resumes == 1
    assert rec.tokens == ref
    assert rec.stream.seq0 == kill_after
    j2.close()


def test_kill_past_kv_ring_wrap_bit_identical(ring_net, tmp_path):
    """Ring of 8, prompt 4, 20 new tokens: positions run past twice the
    ring. A kill after 10 steps resumes through the wrapped gather
    (prompt + 10 = 14 > 8); the tokens must still be identical."""
    kw = dict(max_new_tokens=20, temperature=0.8, seed=13)

    def engine(journal=None):
        return GenerationEngine(
            ring_net, slots=4, max_len=32, device="cpu", journal=journal,
            adapter=AttentionDecodeAdapter(ring_net, max_len=8))

    ref = engine().generate([1, 2, 3, 4], **kw)
    assert len(ref) == 20
    for kill_after in (2, 6, 10):
        p = str(tmp_path / f"j{kill_after}.ndjson")
        eng = engine(SessionJournal(p))
        eng.submit([1, 2, 3, 4], request_id="w", **kw)
        _kill(eng, kill_after)
        j2 = SessionJournal(p)
        eng2 = engine(j2)
        assert j2.resume_into(eng2)["resumed"] == 1
        eng2.drain()
        assert j2.get("w").tokens == ref, f"kill at {kill_after}"
        j2.close()


def test_double_kill_still_bit_identical(lstm_net, tmp_path):
    ref = GenerationEngine(lstm_net, slots=4, max_len=64,
                           device="cpu").generate([4, 5], **SAMPLER)
    p = str(tmp_path / "j.ndjson")
    eng = GenerationEngine(lstm_net, slots=4, max_len=64, device="cpu",
                           journal=SessionJournal(p))
    eng.submit([4, 5], request_id="r", **SAMPLER)
    _kill(eng, 3)
    for steps in (4, None):
        j = SessionJournal(p)
        eng = GenerationEngine(lstm_net, slots=4, max_len=64, device="cpu",
                               journal=j)
        j.resume_into(eng)
        if steps is not None:
            _kill(eng, steps)
    eng.drain()
    rec = j.get("r")
    assert rec.tokens == ref and rec.resumes == 2
    j.close()


def test_crash_after_last_token_completes_on_restart(lstm_net, tmp_path):
    p = str(tmp_path / "j.ndjson")
    j = SessionJournal(p)
    eng = GenerationEngine(lstm_net, slots=4, max_len=64, device="cpu",
                           journal=j)
    ref = eng.generate([1], request_id="r", **SAMPLER)
    j.close()
    lines = open(p).readlines()
    assert json.loads(lines[-1])["e"] == "fin"
    with open(p, "w") as f:
        f.writelines(lines[:-1])       # the fin line lost in the crash
    j2 = SessionJournal(p)
    eng2 = GenerationEngine(lstm_net, slots=4, max_len=64, device="cpu",
                            journal=j2)
    assert j2.resume_into(eng2) == {"resumed": 0, "lost": 0, "completed": 1}
    rec = j2.get("r")
    assert rec.finish_reason == "length" and rec.tokens == ref
    j2.close()


def test_oversize_resume_is_lost_not_wedged(lstm_net, tmp_path):
    p = str(tmp_path / "j.ndjson")
    eng = GenerationEngine(lstm_net, slots=4, max_len=64, device="cpu",
                           journal=SessionJournal(p))
    eng.submit(list(range(1, 9)), request_id="big", max_new_tokens=40,
               temperature=0.5, seed=1)
    _kill(eng, 2)
    j2 = SessionJournal(p)
    small = GenerationEngine(lstm_net, slots=4, max_len=8, device="cpu",
                             journal=j2)
    assert j2.resume_into(small) == {"resumed": 0, "lost": 1, "completed": 0}
    assert j2.get("big").lost and j2.interrupted() == []
    j2.close()


def test_jax_journal_resumes_in_the_port(tmp_path):
    """The JAX engine journals a greedy session and is preempted; the
    port, on the carried weights, resumes the JAX file and ends as the JAX
    package's uninterrupted run."""
    conf = (JaxNNC.builder().seed(7).list().layer(JaxLSTM(n_out=12))
            .layer(JaxRnnOut(n_out=V, activation="softmax", loss="mcxent"))
            .set_input_type(JaxInputType.recurrent(V, 8)).build())
    jnet = JaxNet(conf).init()
    net = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        conf.to_json())).init(device="cpu")
    load_jax_params(net, jax.tree_util.tree_map(np.asarray, jnet.params))
    kw = dict(max_new_tokens=10)
    ref = JaxEngine(jnet, slots=4, max_len=64).generate([2, 6, 1], **kw)
    p = str(tmp_path / "j.ndjson")
    jeng = JaxEngine(jnet, slots=4, max_len=64, journal=JaxJournal(p))
    jeng.submit([2, 6, 1], request_id="x", **kw)
    for _ in range(4):
        jeng.step()
    jeng.shutdown(timeout=0, reason="preempted")
    jeng.journal.close()
    j = SessionJournal(p)
    eng = GenerationEngine(net, slots=4, max_len=64, device="cpu", journal=j)
    assert j.resume_into(eng)["resumed"] == 1
    eng.drain()
    assert j.get("x").tokens == ref
    j.close()
    assert JaxJournal(p).get("x").finish_reason == "length"


def test_unconfigured_engine_makes_zero_journal_calls(lstm_net, monkeypatch):
    calls = []
    for meth in ("attach", "emitted", "finished"):
        monkeypatch.setattr(SessionJournal, meth,
                            lambda self, *a, _m=meth, **k: calls.append(_m))
    eng = GenerationEngine(lstm_net, slots=2, max_len=64, device="cpu")
    eng.generate([1, 2], max_new_tokens=4, request_id="ignored")
    assert calls == []
