"""The port's erasure-code plugin layer (ceph_tpu_torch.ec) against the
committed corpus and against the JAX package's codecs.

The port's device runtime (``cuda``) runs here on the CPU (``device="cpu"``),
where gf_matvec is its plain torch version; the JAX codecs run their device
runtime (``tpu``) on the CPU as tests/test_ec.py runs it, and their numpy
oracle (``cpu``).  Inputs are made by numpy from fixed seeds; every
comparison is byte for byte.
"""

import itertools
import json
import os

import numpy as np
import pytest
import torch

from ceph_tpu.ec import registry_instance as j_registry
from ceph_tpu.tools import ec_non_regression as j_corpus
from ceph_tpu_torch.ec import registry_instance
from ceph_tpu_torch.ec.base import to_host
from ceph_tpu_torch.ops import gf_kernel as gk
from ceph_tpu_torch.tools import ec_non_regression as corpus

REG = registry_instance()


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once: torch's own
    thread pool in each of them would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _decodable_patterns(codec):
    """Every erasure pattern of 1..m chunks, as sets."""
    n, m = codec.get_chunk_count(), codec.get_coding_chunk_count()
    for e in range(1, m + 1):
        for lost in itertools.combinations(range(n), e):
            yield set(lost)


# -- the committed corpus -----------------------------------------------------

@pytest.mark.parametrize("runtime", ["cuda", "cpu"])
@pytest.mark.parametrize("name,plugin,profile", corpus.CONFIGS,
                         ids=[c[0] for c in corpus.CONFIGS])
def test_corpus_chunks_and_decodes(name, plugin, profile, runtime):
    """Every corpus profile reproduces the golden chunks byte for byte, and
    every pattern of up to m erasures the code recovers decodes back to
    them (shec and lrc report the ones they cannot)."""
    codec = corpus.codec_for(plugin, profile, runtime, device="cpu")
    enc = corpus.encode_all(codec)
    stored = np.load(os.path.join(corpus.DEFAULT_DIR, f"{name}.npz"))
    n = codec.get_chunk_count()
    assert sorted(enc) == list(range(n))
    for i in range(n):
        assert enc[i] == stored[f"chunk_{i}"].tobytes(), (name, i)
    recovered = 0
    for lost in _decodable_patterns(codec):
        try:
            dec = codec.decode(set(range(n)),
                               {i: enc[i] for i in range(n) if i not in lost})
        except IOError:
            assert plugin in ("shec", "lrc"), (name, lost)
            continue
        recovered += 1
        assert all(dec[i] == enc[i] for i in range(n)), (name, lost)
    assert recovered > 0


def test_corpus_covers_every_plugin():
    plugins = {plugin for _name, plugin, _p in corpus.CONFIGS}
    assert plugins == {"jerasure", "isa", "shec", "lrc", "clay"}
    assert plugins == set(REG.names())
    assert corpus.CONFIGS == j_corpus.CONFIGS
    assert corpus.payload() == j_corpus._payload()


def test_check_tool_reads_the_committed_corpus():
    assert os.path.realpath(corpus.DEFAULT_DIR) == os.path.realpath(
        j_corpus.DEFAULT_DIR)
    assert corpus.main(["--check", "--device", "cpu"]) == 0


def test_create_never_rewrites_the_committed_corpus(tmp_path):
    with pytest.raises(SystemExit):
        corpus.main(["--create"])
    assert corpus.main(["--create", "--directory", corpus.DEFAULT_DIR]) == 1
    assert corpus.main(["--create", "--directory", str(tmp_path)]) == 0
    assert corpus.check(str(tmp_path), device="cpu") == 0


# -- the port against the JAX codecs ------------------------------------------

#: a pyramid: a global k=4 m=2 layer and two local k=2 m=1 layers, each
#: on another plugin or technique
LRC_LAYERS = json.dumps([
    ["_cDD_cDD", {"plugin": "jerasure", "technique": "reed_sol_van"}],
    ["c_DD____", {"plugin": "isa"}],
    ["____c_DD", {"plugin": "jerasure", "technique": "cauchy_good"}],
])

#: (plugin, profile): every plugin and technique, the JAX tests' shapes
PLUGINS = [
    ("jerasure", {"technique": "reed_sol_van", "k": "4", "m": "2"}),
    ("jerasure", {"technique": "reed_sol_van", "k": "7", "m": "3"}),
    ("jerasure", {"technique": "reed_sol_r6_op", "k": "6", "m": "2"}),
    ("jerasure", {"technique": "cauchy_orig", "k": "5", "m": "3"}),
    ("jerasure", {"technique": "cauchy_good", "k": "8", "m": "4"}),
    ("jerasure", {"technique": "blaum_roth", "k": "4", "m": "2", "w": "6"}),
    ("jerasure", {"technique": "liberation", "k": "4", "m": "2", "w": "7"}),
    ("jerasure", {"technique": "liber8tion", "k": "4", "m": "2"}),
    ("isa", {"technique": "reed_sol_van", "k": "4", "m": "2"}),
    ("isa", {"technique": "cauchy", "k": "10", "m": "4"}),
    ("shec", {"k": "4", "m": "3", "c": "2"}),
    ("lrc", {"mapping": "__DD__DD", "layers": LRC_LAYERS}),
    ("clay", {"k": "4", "m": "2"}),
    ("clay", {"k": "3", "m": "3"}),
]
PLUGIN_IDS = [f"{p}-{prof.get('technique', '')}-k{prof.get('k', '')}"
              f"m{prof.get('m', '')}" for p, prof in PLUGINS]


@pytest.mark.parametrize("runtime", ["cuda", "cpu"])
@pytest.mark.parametrize("plugin,profile", PLUGINS, ids=PLUGIN_IDS)
def test_codec_matches_jax_codec(plugin, profile, runtime):
    """The port's codec and the JAX package's on the same random payloads
    and erasure patterns, encode and decode bit for bit: the port's cuda
    runtime (plain torch here) against the JAX device runtime, the numpy
    oracles against each other."""
    mine = REG.factory(plugin, dict(profile, runtime=runtime), "cpu")
    ref = j_registry().factory(
        plugin, dict(profile, runtime="tpu" if runtime == "cuda" else "cpu"))
    n = mine.get_chunk_count()
    assert (n, mine.get_data_chunk_count(), mine.get_sub_chunk_count()) == (
        ref.get_chunk_count(), ref.get_data_chunk_count(),
        ref.get_sub_chunk_count())
    rng = np.random.default_rng(PLUGINS.index((plugin, profile)))
    patterns = list(_decodable_patterns(mine))
    for size in (1, 1000, 4099):
        data = rng.integers(0, 256, size, dtype=np.uint8).tobytes()
        assert mine.get_chunk_size(size) == ref.get_chunk_size(size)
        enc = mine.encode(set(range(n)), data)
        assert enc == ref.encode(set(range(n)), data)
        for j in rng.choice(len(patterns), min(6, len(patterns)),
                            replace=False):
            lost = patterns[j]
            avail = {i: enc[i] for i in range(n) if i not in lost}
            try:
                want = ref.decode(set(range(n)), avail)
            except IOError:
                with pytest.raises(IOError):
                    mine.decode(set(range(n)), avail)
                continue
            assert mine.decode(set(range(n)), avail) == want, lost
            assert mine.minimum_to_decode(set(lost), set(avail)) == \
                ref.minimum_to_decode(set(lost), set(avail))


@pytest.mark.parametrize("plugin,profile", [
    ("jerasure", {"technique": "cauchy_good", "k": "4", "m": "2"}),
    ("isa", {"technique": "reed_sol_van", "k": "8", "m": "3"}),
    ("jerasure", {"technique": "blaum_roth", "k": "4", "m": "2", "w": "6"}),
    ("jerasure", {"technique": "liber8tion", "k": "4", "m": "2"}),
])
def test_chunk_calls_match_jax_and_stay_on_device(plugin, profile):
    """encode_chunks/decode_chunks on an (S, k, B) batch: tensors on the
    codec's device on the cuda runtime, numpy on the oracle, equal to the
    JAX device runtime's arrays."""
    mine = REG.factory(plugin, dict(profile), "cpu")
    oracle = REG.factory(plugin, dict(profile, runtime="cpu"))
    ref = j_registry().factory(plugin, dict(profile, runtime="tpu"))
    k, n = mine.get_data_chunk_count(), mine.get_chunk_count()
    rng = np.random.default_rng(11)
    b = mine.get_chunk_size(k * 300)
    data = rng.integers(0, 256, (5, k, b), dtype=np.uint8)
    parity = mine.encode_chunks(data)
    assert isinstance(parity, torch.Tensor) and parity.device.type == "cpu"
    assert isinstance(oracle.encode_chunks(data), np.ndarray)
    want = np.asarray(ref.encode_chunks(data))
    np.testing.assert_array_equal(parity.numpy(), want)
    np.testing.assert_array_equal(
        mine.encode_chunks(torch.from_numpy(data)).numpy(), want)
    full = np.concatenate([data, want], axis=1)
    lost = [1, k]
    chosen = [i for i in range(n) if i not in lost][:k]
    got = mine.decode_chunks(chosen, full[:, chosen], lost)
    assert isinstance(got, torch.Tensor)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(ref.decode_chunks(chosen, full[:, chosen],
                                                  lost)))
    np.testing.assert_array_equal(got.numpy(), full[:, lost])


# -- tables cut to fit the kernel's shared memory -----------------------------

class _Launches:
    """Counts the gf_matvec calls (one kernel launch each on the card)."""

    def __init__(self, monkeypatch):
        self.n = 0
        inner = gk.gf_matvec

        def counted(*args, **kw):
            self.n += 1
            return inner(*args, **kw)
        monkeypatch.setattr(gk, "gf_matvec", counted)


@pytest.mark.parametrize("technique,k,w,launches", [
    ("blaum_roth", 7, 10, 2),     # (20, 70): 350 KiB -> rows 12 + 8
    ("liberation", 8, 11, 3),     # (22, 88): 528 KiB -> rows 8 + 8 + 6
])
@pytest.mark.parametrize("limit", [None, 16 * 1024, 2 * 1024])
def test_big_bitmatrix_codes_cut_their_tables(technique, k, w, launches,
                                              limit, monkeypatch):
    """blaum_roth k=7 (w=10, its default) and liberation k=8 w=11 have
    packed tables larger than the kernel's shared memory: the encoder cuts
    them into row groups at the natural limit, and into row and input
    groups at limits forced small (2 KiB is below k*w: the partial
    products are XOR-accumulated).  Encode and decode equal the JAX
    codec's.  (liber8tion k=8 has the same kind of table, 256 KiB, but
    the construction both packages share does not finish past k=4 at
    w=8; test_cut_products_equal_the_oracle takes its (16, 64) shape.)"""
    cut = gk.cut_tables
    if limit is not None:
        # the codecs build their encoders with the default limit: force
        # this one through the function that applies it
        monkeypatch.setattr(gk, "cut_tables",
                            lambda coeff, device, _limit=None:
                            cut(coeff, device, limit))
    calls = _Launches(monkeypatch)
    profile = {"technique": technique, "k": str(k), "m": "2", "w": str(w)}
    mine = REG.factory("jerasure", profile, "cpu")
    ref = j_registry().factory("jerasure", dict(profile, runtime="cpu"))
    assert mine.w == w
    groups = cut(mine.generator[k * w:], torch.device("cpu"), limit)
    tables = [tab for _r0, _r1, parts in groups for _j0, _j1, tab in parts]
    assert all(4 * tab.numel() <= (limit or gk.TABLE_LIMIT) for tab in tables)
    n_launch = len(tables)
    if limit is None:
        assert n_launch == launches
    rng = np.random.default_rng(k)
    data = rng.integers(0, 256, 3 * k * w * 32 + 5, dtype=np.uint8).tobytes()
    enc = mine.encode(set(range(k + 2)), data)
    assert calls.n == n_launch
    assert enc == ref.encode(set(range(k + 2)), data)
    for lost in ({0, 1}, {2, k}, {k, k + 1}, {k - 1}):
        avail = {i: enc[i] for i in range(k + 2) if i not in lost}
        assert mine.decode(set(range(k + 2)), avail) == ref.decode(
            set(range(k + 2)), avail)


@pytest.mark.parametrize("t,k,b,limit", [
    (20, 70, 33, None), (16, 64, 32, None), (16, 64, 17, 4096),
    (9, 300, 15, 8192), (5, 3, 1, 1024), (4, 8, 4096, None)])
def test_cut_products_equal_the_oracle(t, k, b, limit):
    """ec_encode/make_encoder against ec_encode_ref at widths where the
    kernel takes its byte-at-a-time path (B % 16 != 0), with and without
    cuts; a (k, B) input returns (t, B)."""
    rng = np.random.default_rng(t * k)
    coeff = rng.integers(0, 256, (t, k), dtype=np.uint8)
    data = rng.integers(0, 256, (3, k, b), dtype=np.uint8)
    want = gk.ec_encode_ref(coeff, data)
    got = gk.ec_encode(coeff, data, "cpu", table_limit=limit)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        gk.ec_encode(coeff, data[1], "cpu", table_limit=limit).numpy(),
        want[1])
    groups = gk.cut_tables(coeff, torch.device("cpu"), limit)
    assert all(4 * tab.numel() <= (limit or gk.TABLE_LIMIT)
               for _r0, _r1, parts in groups for _j0, _j1, tab in parts)
    assert [(r0, r1) for r0, r1, _parts in groups][-1][1] == t


# -- registry, profiles, runtimes ---------------------------------------------

def test_profile_runtimes():
    """``tpu`` (the reference's device runtime) reads as ``cuda``; an
    unknown runtime or profile key is refused; the device is a factory
    argument, not a profile key."""
    assert REG.factory("isa", {"runtime": "tpu"}, "cpu").runtime == "cuda"
    assert REG.factory("isa", {}, "cpu").runtime == "cuda"
    assert REG.factory("isa", {"runtime": "native"}).runtime == "native"
    with pytest.raises(ValueError, match="runtime"):
        REG.factory("isa", {"runtime": "gpu"}, "cpu")
    with pytest.raises(ValueError, match="unknown profile keys"):
        REG.factory("isa", {"device": "cpu"}, "cpu")
    with pytest.raises(KeyError):
        REG.factory("nope", {}, "cpu")


def test_lrc_layers_inherit_runtime_and_device():
    codec = REG.factory("lrc", {"mapping": "_DDD_DDD",
                                "layers": corpus.LRC_LAYERS}, "cpu")
    for layer in codec.layers:
        assert layer.codec.runtime == "cuda"
        assert layer.codec._dev == torch.device("cpu")
    codec = REG.factory("lrc", {"mapping": "_DDD_DDD", "runtime": "cpu",
                                "layers": corpus.LRC_LAYERS})
    assert {layer.codec.runtime for layer in codec.layers} == {"cpu"}


def test_device_runtime_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        REG.factory("isa", {})
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        REG.factory("lrc", {"mapping": "_DDD_DDD",
                            "layers": corpus.LRC_LAYERS})
    assert REG.factory("isa", {"runtime": "cpu"}).runtime == "cpu"


def test_codecs_built_directly_default_to_the_card(monkeypatch):
    """A codec constructed without the registry and then init'ed runs the
    device runtime on the card: without one it raises as the factory does,
    and a device set before init is the one it runs on."""
    from ceph_tpu_torch.ec.jerasure import ReedSolomonVandermonde
    from ceph_tpu_torch.ec.lrc import ErasureCodeLrc
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for codec, profile in (
            (ReedSolomonVandermonde(), {"technique": "reed_sol_van",
                                        "k": "4", "m": "2"}),
            (ErasureCodeLrc(), {"mapping": "_DDD_DDD",
                                "layers": corpus.LRC_LAYERS})):
        assert codec.device is None
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            codec.init(profile)
    codec = ReedSolomonVandermonde()
    codec.device = "cpu"
    codec.init({"technique": "reed_sol_van", "k": "4", "m": "2"})
    assert codec._dev == torch.device("cpu")


def test_recovery_caches_are_lru():
    """Matrices and their device tables are kept per (chosen, targets), at
    most DECODE_CACHE_CAP of each, the least recent evicted first."""
    from ceph_tpu_torch.ec import base
    codec = REG.factory("isa", {"k": "4", "m": "3"}, "cpu")
    data = np.random.default_rng(0).integers(0, 256, (2, 7, 64),
                                             dtype=np.uint8)
    full = np.concatenate([data[:, :4], to_host(codec.encode_chunks(
        data[:, :4]))], axis=1)
    pats = list(itertools.combinations(range(7), 3))
    for lost in pats:
        chosen = [i for i in range(7) if i not in lost][:4]
        np.testing.assert_array_equal(
            to_host(codec.decode_chunks(chosen, full[:, chosen], list(lost))),
            full[:, list(lost)])
    assert len(codec._decode_cache) == len(codec._table_cache) == len(pats)
    assert len(pats) <= base.DECODE_CACHE_CAP
    first = next(iter(codec._table_cache))
    codec.decode_chunks(list(first[0]), full[:, list(first[0])],
                        list(first[1]))
    assert next(reversed(codec._table_cache)) == first


def test_create_rule_adds_an_indep_rule():
    from ceph_tpu_torch.crush.builder import build_flat_map
    from ceph_tpu_torch.crush.types import RULE_CHOOSE_INDEP
    m, _root, _rid = build_flat_map(8)
    rid = REG.factory("isa", {"runtime": "cpu"}).create_rule("ec", m)
    assert m.rules[rid].steps[1].op == RULE_CHOOSE_INDEP


def test_ec_benchmark_runs_and_matches_the_oracle(capsys):
    from ceph_tpu_torch.tools import ec_benchmark as eb
    assert eb.main(["--plugin", "isa", "-P", "k=8", "-P", "m=4",
                    "-P", "technique=cauchy", "--size", "8192",
                    "--iterations", "20", "--batch", "8",
                    "--device", "cpu"]) == 0
    elapsed, kib = capsys.readouterr().out.strip().split("\t")
    assert float(elapsed) > 0 and int(kib) == 20 * 8
    for plugin, prof, size in (("isa", ["k=10", "m=4", "technique=cauchy"],
                                65536),
                               ("jerasure", ["k=7", "technique=blaum_roth"],
                                7 * 10 * 32 * 4)):
        profile = dict(kv.split("=") for kv in prof)
        codec = REG.factory(plugin, profile, "cpu")
        oracle = REG.factory(plugin, dict(profile, runtime="cpu"))
        run = eb.bench_encode(codec, size, 10, 4)
        assert run.kib == 10 * size // 1024 and run.out.shape[0] == 2
        np.testing.assert_array_equal(
            run.out, oracle.encode_chunks(run.data[:2]))
        run = eb.bench_decode(codec, size, 6, 4, 2, False)
        full = np.concatenate([run.data, oracle.encode_chunks(run.data)],
                              axis=1)
        assert len(run.lost) == 2
        np.testing.assert_array_equal(run.out, full[:2, list(run.lost)])
