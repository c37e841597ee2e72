"""The port's measurement tools run end to end on the CPU at tiny sizes
(``--device cpu``: the kernels' plain twins, host clock), reach the kernel
wrappers they exist for, and refuse a CUDA device where there is none."""

import functools

import pytest
import torch

from irn_tpu_torch.ops import matpow_kernels as tmk
from irn_tpu_torch.ops import random_walk as trw
from irn_tpu_torch.tools import bench_banded, bench_conv, resolve_device

torch.set_num_threads(2)
CPU = torch.device("cpu")


def _spy(monkeypatch, module, name):
    calls = []
    orig = getattr(module, name)

    @functools.wraps(orig)
    def spy(*args, **kw):
        calls.append(name)
        return orig(*args, **kw)

    monkeypatch.setattr(module, name, spy)
    return calls


def test_bench_banded_batched_sweep_reaches_k8(monkeypatch, capsys):
    """The batched sweep through main() at e = 1 on a (64, 16) bucket
    (n_pad 2048, bs 512: the band fits) goes through K8's wrapper once per
    group."""
    calls = _spy(monkeypatch, tmk, "packed_chain_batched")
    rows = bench_banded.main([
        "--device", "cpu", "--cap", "64", "16", "--reps", "1",
        "--batch_only", "--batch_sizes", "1", "2", "--square_times", "1"])
    assert [(r["sweep"], r["B"], r["e"]) for r in rows] == [
        ("batched", 1, 1), ("batched", 2, 1)]
    assert all(r["ms"] > 0 for r in rows)
    # (1 warm-up + 1 timed run) x (8 groups of 1 + 4 groups of 2)
    assert len(calls) == 2 * 8 + 2 * 4
    out = capsys.readouterr().out
    assert "batched e=1 B=2" in out and "not a device time" in out


def test_bench_banded_dense_and_banded_sweeps():
    """The dense hybrid and the e x bj sweep on a 16x16 bucket at bs 128
    (n_pad 1024): e = 0 (stencil) and e = 1 at bj 128 (K1 + K3) and 256
    (K7)."""
    geom = trw.build_geometry(16, 16, radius=5)
    rows = bench_banded.dense_sweep(geom, CPU, "cpu", reps=1, n_images=1)
    assert rows[0]["e"] == trw.pick_square_times(geom.n_pad, 8)
    rows = bench_banded.banded_sweep(geom, CPU, "cpu", reps=1, n_images=1,
                                     es=(0, 1), bjs=(128, 256), bs=128)
    assert [(r["e"], r["bj"]) for r in rows] == [
        (0, 128), (0, 256), (1, 128), (1, 256)]


def test_bench_conv_sweep_on_cpu():
    """The conv probe at one small odd shape: on the CPU the wrapper is the
    twin, so it is bit-equal to it; cuDNN's slot times torch's bf16 conv."""
    rows = bench_conv.sweep(CPU, reps=1,
                            shapes=[("odd", 2, 13, 11, 32, 48)])
    (row,) = rows
    assert row["gflop"] == pytest.approx(2 * 2 * 13 * 11 * 32 * 48 * 9 / 1e9)
    assert row["max_abs_err"] == 0.0 and row["bit_equal"] == 1.0
    assert min(row["ms"], row["plain_ms"], row["cudnn_ms"]) > 0
    x, k = bench_conv.make_inputs(2, 13, 11, 32, 48, CPU)
    ref = bench_conv.conv3x3_plain(x, k).float()
    got = bench_conv.cudnn_conv(x, bench_conv.cudnn_weight(k)).float()
    assert float((got - ref).abs().max()) <= 2.0 ** -6 * float(ref.abs().max())


def test_probe_ccl_plain_path(monkeypatch, capsys):
    """The K12 probe (tools/probe_ccl.py) through main() on the CPU at its
    small size: each case through the stage's wrapper (their plain twins
    here), equal, timed on the host clock, with no device rows; the
    speckle map flags overflow at comp_cap 128; a missing card raises."""
    from irn_tpu_torch.ops import ccl
    from irn_tpu_torch.tools import probe_ccl

    clusters = _spy(monkeypatch, ccl, "cluster_from_basin")
    tables = _spy(monkeypatch, ccl, "component_tables")
    res = probe_ccl.main(["--device", "cpu", "--small", "--reps", "1"])
    cases = res["cases"]
    assert list(cases) == ["basin", "map 384x512", "map 500x500",
                           "speckle cap 128", "speckle cap 4096"]
    for r in cases.values():
        assert r["equal"] and r["ms"] > 0 and "device_us" not in r
    assert 1 < cases["basin"]["count"] <= probe_ccl.K_CAP + 1
    assert cases["map 384x512"]["count"] <= probe_ccl.COMP_CAP
    assert cases["speckle cap 128"]["count"] == probe_ccl.COMP_CAP + 1
    # per case: the check, the twin, and a warm-up and one timed call for
    # each of the two clocks
    assert len(clusters) == 6 and len(tables) == 4 * 6
    assert "not a device time" in capsys.readouterr().out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        probe_ccl.main(["--small"])


def test_probe_walk_ops_plain_path(monkeypatch, capsys):
    """The K10 / K15 probe (tools/probe_walk_ops.py) through main() on the
    CPU at its small size: each case through the walk's wrappers (their
    plain twins here), equal, timed on the host clock, with no device rows;
    the instance case asks for int32 labels; a missing card raises."""
    from irn_tpu_torch.tools import probe_walk_ops

    ops = _spy(monkeypatch, trw, "build_diag_operator")
    decodes = _spy(monkeypatch, trw, "decode")
    ups = _spy(monkeypatch, trw, "upsample_scores")
    res = probe_walk_ops.main(["--device", "cpu", "--small", "--reps", "1"])
    cases = res["cases"]
    assert list(cases) == ["diag_operator", "decode C 8",
                           "decode C 8 scores best", "decode C 16 best int32",
                           "upsample C 8"]
    for r in cases.values():
        assert r["equal"] and r["ms"] > 0 and r["host_us"] > 0
        assert "device_us" not in r
    assert "labels_dtype in this tree: True" in \
        cases["decode C 16 best int32"]["shape"]
    assert "host_pieces_us" not in res
    # per case: the check, and a warm-up and one timed call for each of the
    # three clocks
    assert len(ops) == 7 and len(decodes) == 3 * 7 and len(ups) == 7
    assert "not a device time" in capsys.readouterr().out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        probe_walk_ops.main(["--small"])


def test_probe_walk_variants_sources(monkeypatch):
    """The K10 / K15 variant probe (tools/probe_walk_variants.py): every
    variant's edits and phase stamps apply to the sources as they are (a
    source edit that no longer matches raises), each variant that edits a
    source differs from the source as built, and without a card it
    refuses to run."""
    from irn_tpu_torch.tools import probe_walk_variants as pv

    vs = pv.variants()
    assert len(vs) == 8
    for name, (kernel, text, overrides) in vs.items():
        assert kernel in name.replace("K10", "diag_operator").replace(
            "K15", "decode")
        assert text.count("stamp(") == 5 and "irn_get_stamps" in text
        built = vs["K10 as built" if kernel == "diag_operator"
                   else "K15 as built"][1]
        assert (text != built) == (name in (
            "K10 beta at run time", "K10 4x32 tiles", "K15 256-thread CTAs",
            "K15 recomputed"))
        assert bool(overrides) == (name in (
            "K10 4x32 tiles", "K10 two groups", "K10 one group"))
    with pytest.raises(ValueError, match="found 0 times"):
        pv._edit("abc", "x", "y")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        pv.main([])


def test_probe_advect_plain_path(monkeypatch, capsys):
    """The K11 probe (tools/probe_advect.py) through main() on the CPU at
    its small size: the four cases (basin, full gain, random, the IRN
    forward's dp) through ``centroids.advect`` (its plain twin here),
    equal, timed on the host clock, with no device rows; ``--variants``
    and a missing card refuse."""
    from irn_tpu_torch.ops import centroids
    from irn_tpu_torch.tools import probe_advect

    calls = _spy(monkeypatch, centroids, "advect")
    res = probe_advect.main(["--device", "cpu", "--small", "--reps", "1"])
    cases = res["cases"]
    assert list(cases) == ["basin", "full gain", "random", "irn forward"]
    for r in cases.values():
        assert r["equal"] and r["ms"] > 0 and "device_us" not in r
    # per case: the check, a warm-up and one timed call for each of the
    # three clocks
    assert len(calls) == 4 * 7
    assert "not a device time" in capsys.readouterr().out
    with pytest.raises(ValueError, match="the card only"):
        probe_advect.main(["--device", "cpu", "--small", "--variants"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        probe_advect.main(["--small"])


def test_probe_advect_variants_name_the_source_constants():
    """The K11 variant builds (tools/probe_advect.py): every variant's edits
    of the source's constants and stop rule apply to ``csrc/advect.cu`` as
    it is (an edit that no longer matches raises), each variant but the
    one as built differs from it, and the clock stamps and their readers
    go into every variant; the source itself has no build-time option."""
    from irn_tpu_torch.tools import probe_advect as pa

    vs = pa.variants()
    assert len(vs) == 11
    for name, text in vs.items():
        assert (text != vs["as built"]) == (name != "as built"), name
        st = pa.stamped(text)
        assert st.count("stamp(") == 6 and "irn_advect_probe_read" in st
    assert "#ifndef" not in vs["as built"] and "#ifdef" not in vs["as built"]
    assert "constexpr int kChunk = 16;" in vs["chunk 16"]
    assert "named_sync" not in vs["no pooled wait"]
    assert "__syncthreads_or" not in vs["no staged check"]
    with pytest.raises(ValueError, match="found 0 times"):
        pa._edit("abc", "x", "y")


def test_tools_refuse_a_missing_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    with pytest.raises(RuntimeError):
        bench_conv.main(["--device", "cuda"])
    with pytest.raises(RuntimeError):
        bench_banded.main(["--device", "cuda", "--batch_only"])
    assert resolve_device("cpu") == CPU


SASS = """\
	code for sm_90a
		Function : _ZN12_GLOBAL__N_111rows_kernelILi1EEEvPKhPKfPhPf
	.headerflags	@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS"
        /*0000*/                   LDC R1, c[0x0][0x28] ;   /* 0x00000a00ff017b82 */
        /*0010*/                   FMUL R2, R3, R4 ;        /* 0x0000000403027220 */
        /*0020*/                   MUFU.EX2 R5, R2 ;        /* 0x0000000200057308 */
        /*0030*/               @P0 BRA 0x60 ;               /* 0x0000000000000947 */
        /*0040*/                   STG.E.128 desc[UR4][R6.64], R8 ;
        /*0050*/                   BRA 0x80 ;
        /*0060*/                   STG.E.U8 desc[UR4][R6.64], R9 ;
        /*0070*/                   STG.E.U8 desc[UR4][R6.64+0x1], R10 ;
        /*0080*/                   IADD3 R0, R0, 0x1, RZ ;
        /*0090*/               @P1 BRA 0x10 ;               /* 0xfffffffc00e80947 */
        /*00a0*/                   EXIT ;
        /*00b0*/                   BRA 0xb0;
        /*00c0*/                   NOP;
		Function : _ZN12_GLOBAL__N_111table_kernelEPKhPf
        /*0000*/                   MUFU.EX2 R5, R2 ;
        /*0010*/                   EXIT ;
"""


def test_probe_crf_landmark_sass_loop():
    """The K14 probe's SASS count (tools/probe_crf_landmark.py): the
    innermost loop that holds an exp, its byte-store block left out, the
    instructions over its exps; a kernel named by a substring of its
    mangled name; no loop, or no such kernel, raises."""
    from irn_tpu_torch.ops import _build
    from irn_tpu_torch.tools import probe_crf_landmark as probe

    fns = _build.sass_functions(SASS)
    assert len(fns) == 2
    n, ex2, listing = probe.sass_loop(fns[next(iter(fns))])
    assert (n, ex2) == (7, 1)
    assert [line.split()[0] for line in listing] == [
        "00010", "00020", "00030", "00040", "00050", "00080", "00090"]
    per_entry, _ = probe.sass_per_entry(SASS, "rows_kernelILi1E")
    assert per_entry == 7.0
    with pytest.raises(RuntimeError):
        probe.sass_per_entry(SASS, "table_kernel")
    with pytest.raises(RuntimeError):
        probe.sass_per_entry(SASS, "no_such_kernel")
