"""The port's qmm kernel lab (``tpu_kquant_torch/utils/kernel_lab.py``, its
roofline, profiling and attribution modules and the two CLIs) against the
JAX package's.

On the CPU ``lab_qmm`` / ``lab_qmm_manual`` run their plain versions; these
tests hold them to the reference's Pallas lab in interpret mode on the same
bytes (drawn by the reference's ``tools_kernel_bench.mk_q4`` / ``mk_q6w``).
Tolerances, of max|ref|: dma and extract are integer sums, held bit-equal;
convert, full and gdot sum the same f32 products in another order, 1e-4;
bf16c 1e-2, because XLA on the CPU may keep the bf16 chain's intermediates
in f32 (skipping a rounding the port makes). The CUDA kernels are held to
these plain versions on a card (tests/test_torch_cuda.py, chip_smoke.py).

The reference's lab has two faults the port does not copy; the tests pin
them: its f32-scale q4 rungs drop the mins, and its manual kernel reads a
fixed x chunk and the low fold's scale rows for both folds.
"""

import functools
import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import tools_kernel_bench as ref_bench
from tpu_kquant.quant.qtensor import QTensor as JQTensor
from tpu_kquant.quant.repack import pack_scale_kpairs as j_pack_kpairs
from tpu_kquant.utils import kernel_lab as jlab
from tpu_kquant_torch.quant.codecs import dequant_kmajor
from tpu_kquant_torch.quant.qtensor import QTensor
from tpu_kquant_torch.tools import kernel_bench as t_bench
from tpu_kquant_torch.tools import kernel_lab as t_lab_cli
from tpu_kquant_torch.utils import attribution, profiling, roofline
from tpu_kquant_torch.utils import kernel_lab as tlab

torch.set_num_threads(1)

N = 256
TOL = {"dma": 0.0, "extract": 0.0, "convert": 1e-4, "full": 1e-4, "gdot": 1e-4, "bf16c": 1e-2}
# kind label -> (K, JAX s_fmt / port s_fmt)
KINDS = {"q4-sm": (512, "sm"), "q6w-sp": (1024, "sp"), "q6w-f32": (1024, "f32"),
         "q8-sp": (512, "sp")}
TK, TN = 128, 128  # nk = K/2 / 128 >= 2 chunks, N / 128 = 2 column tiles


def _jax_arrays(qt):
    return JQTensor(qt.kind, qt.layout, tuple(qt.shape),
                    {k: jnp.asarray(np.asarray(v)) for k, v in qt.arrays.items()})


def _port(qt) -> QTensor:
    return QTensor(qt.kind, qt.layout, tuple(qt.shape),
                   {k: np.array(v) for k, v in qt.arrays.items()}).to("cpu")


@functools.lru_cache(maxsize=None)
def _weights(label: str):
    """(JAX QTensor, port QTensor, s_fmt) drawn by the reference's makers."""
    K, s_fmt = KINDS.get(label, (512, "f32"))
    rng = np.random.default_rng(sum(map(ord, label)))
    if label == "q4-sm":
        qt = ref_bench.mk_q4(N, K, rng)
    elif label == "q4-f32":
        qt = ref_bench.mk_q4(N, K, rng, sm=False)
    elif label.startswith("q6w"):
        qt = ref_bench.mk_q6w(N, K, rng, sp=s_fmt == "sp")
    else:  # q8: Q8_0 codes, 32-row groups, adjacent-group scale pairs
        qt = JQTensor("q8", "kmajor", (N, K), {
            "qs": jnp.asarray(rng.integers(-127, 128, (K, N)).astype(np.int8)),
            "scales": jnp.asarray(rng.random((K // 32, N), dtype=np.float32) * 0.01)})
        qt = _jax_arrays(j_pack_kpairs(qt))
    return _jax_arrays(qt), _port(qt), s_fmt


def _x(R: int, K: int, seed: int = 5) -> np.ndarray:
    """bf16-exact activations as f32."""
    x = np.random.default_rng(seed).standard_normal((R, K)).astype(np.float32)
    return torch.from_numpy(x).to(torch.bfloat16).float().numpy()


def _jax_lab(jqt, mode, s_fmt, x, geometry):
    K = int(jqt.shape[1])
    keys = tuple(sorted(jqt.arrays))
    R = x.shape[0]
    out = jlab.lab_qmm(jnp.asarray(x, jnp.bfloat16), jnp.ones((R, K), jnp.int8),
                       tuple(jqt.arrays[k] for k in keys), mode, jqt.kind, s_fmt, keys,
                       int(jqt.shape[0]), K, TK, geometry=geometry, tn=TN, interpret=True)
    return np.asarray(out)


def _port_lab(tqt, mode, s_fmt, x, geometry):
    xt = torch.from_numpy(x).to(torch.bfloat16)
    xi8 = torch.ones((x.shape[0], x.shape[1]), dtype=torch.int8)
    return tlab.lab_qmm(xt, xi8, tqt, mode, s_fmt, TK, geometry=geometry, tn=TN).numpy()


def _rel(got, ref) -> float:
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


def _x_at_w(tqt, x) -> np.ndarray:
    return x @ dequant_kmajor(tqt).numpy()


@pytest.mark.parametrize("sm", [True, False])
def test_mk_q4_draws_the_reference_bytes(sm):
    a = ref_bench.mk_q4(256, 512, np.random.default_rng(3), sm=sm)
    b = t_bench.mk_q4(256, 512, np.random.default_rng(3), sm=sm)
    assert set(a.arrays) == set(b.arrays)
    for k in a.arrays:
        assert np.asarray(a.arrays[k]).tobytes() == np.asarray(b.arrays[k]).tobytes(), k


@pytest.mark.parametrize("sp", [True, False])
def test_mk_q6w_draws_the_reference_bytes(sp):
    a = ref_bench.mk_q6w(256, 512, np.random.default_rng(4), sp=sp)
    b = t_bench.mk_q6w(256, 512, np.random.default_rng(4), sp=sp)
    assert set(a.arrays) == set(b.arrays)
    for k in a.arrays:
        assert np.asarray(a.arrays[k]).tobytes() == np.asarray(b.arrays[k]).tobytes(), k


def test_models_match_the_reference():
    for name, shape in ref_bench.MODELS.items():
        assert t_bench.MODELS[name] == shape
    assert tlab.MODES == jlab.MODES


@pytest.mark.parametrize("R", [1, 3])
@pytest.mark.parametrize("label", sorted(KINDS))
@pytest.mark.parametrize("geometry", ["k", "n"])
@pytest.mark.parametrize("mode", jlab.MODES)
def test_lab_qmm_plain_matches_reference(mode, geometry, label, R):
    jqt, tqt, s_fmt = _weights(label)
    x = _x(R, int(tqt.shape[1]))
    ref = _jax_lab(jqt, mode, s_fmt, x, geometry)
    got = _port_lab(tqt, mode, s_fmt, x, geometry)
    assert got.shape == ref.shape and got.dtype == np.float32
    if TOL[mode] == 0.0:
        np.testing.assert_array_equal(got, ref)
    else:
        assert _rel(got, ref) <= TOL[mode], (mode, geometry, label, R, _rel(got, ref))


@pytest.mark.parametrize("geometry", ["k", "n"])
@pytest.mark.parametrize("mode", ["bf16c", "full", "gdot"])
def test_q4_f32_scales_reference_drops_the_mins(mode, geometry):
    """Fault 2: on f32 scales the reference's q4 rungs never read the mins;
    its result is the port's with the mins zeroed, and the port's is x @ W."""
    jqt, tqt, _ = _weights("q4-f32")
    x = _x(2, int(tqt.shape[1]))
    ref = _jax_lab(jqt, mode, "f32", x, geometry)
    no_mins = QTensor(tqt.kind, tqt.layout, tqt.shape,
                      {**tqt.arrays, "mins": torch.zeros_like(tqt.arrays["mins"])})
    assert _rel(_port_lab(no_mins, mode, "f32", x, geometry), ref) <= TOL[mode]
    xw = _x_at_w(tqt, x)
    got = _port_lab(tqt, mode, "f32", x, geometry)
    # full / bf16c round w to bf16 (2^-9 of each weight); gdot keeps f32
    assert _rel(got, xw) <= (1e-4 if mode == "gdot" else 1e-2)
    assert _rel(ref, xw) > 5e-2  # the fault is visible at this size


def _manual_defect_model(tqt, x, s_fmt, tk2):
    """The reference's manual kernel as it is: each chunk i multiplies fold
    f's codes with the fixed x columns [f K/2, f K/2 + TK2) and uses the low
    fold's scale rows [i sg, (i + 1) sg) for both folds (mins: only from sm)."""
    qs = tqt.arrays["qs"].numpy()
    K2, Nn = qs.shape
    nk, sg = K2 // tk2, tk2 // 32
    if s_fmt == "sm":
        bits = tqt.arrays["sm"].numpy().view(np.uint32)
        s = (bits << 16).view(np.float32)
        m = (bits & 0xFFFF0000).view(np.float32)
    else:
        s, m = tqt.arrays["scales"].numpy(), None
    x = x.astype(np.float64)
    y = np.zeros((x.shape[0], Nn))
    for i in range(nk):
        tile = qs[i * tk2:(i + 1) * tk2]
        si = np.repeat(s[i * sg:(i + 1) * sg], 32, axis=0).astype(np.float64)
        for f in (0, 1):
            codes = ((tile >> 4) if f else (tile & 15)).astype(np.float64)
            xc = x[:, f * K2:f * K2 + tk2]
            y += xc @ (codes * si)
            if m is not None:
                y -= xc.reshape(x.shape[0], sg, 32).sum(-1) @ m[i * sg:(i + 1) * sg]
    return y


@pytest.mark.parametrize("s_fmt", ["sm", "f32"])
@pytest.mark.parametrize("nk", [1, 2, 4])
def test_manual_reference_fault_and_port_computes_x_at_w(nk, s_fmt):
    """Fault 1: the reference's lab_qmm_manual equals a model of its defect;
    the port's manual kernel computes x @ dequant(W), and its dma rung
    equals the reference's bit for bit."""
    K = 1024
    rng = np.random.default_rng(40 + nk)
    jq = ref_bench.mk_q4(N, K, rng, sm=s_fmt == "sm")
    jqt, tqt = _jax_arrays(jq), _port(jq)
    tk2 = (K // 2) // nk
    x = _x(2, K)
    keys = tuple(sorted(jqt.arrays))
    arrays = tuple(jqt.arrays[k] for k in keys)
    xj = jnp.asarray(x, jnp.bfloat16)

    def jax_manual(mode):
        return np.asarray(jlab.lab_qmm_manual(xj, arrays, mode, s_fmt, keys, N, K, tk2,
                                              interpret=True))

    ref = jax_manual("full")
    model = _manual_defect_model(tqt, x, s_fmt, tk2)
    assert _rel(ref, model) <= 1e-4
    xt = torch.from_numpy(x).to(torch.bfloat16)
    got = tlab.lab_qmm_manual(xt, tqt, "full", s_fmt, tk2).numpy()
    xw = _x_at_w(tqt, x)
    assert _rel(got, xw) <= 1e-4
    assert _rel(ref, xw) > 5e-2  # the reference's defect is visible
    np.testing.assert_array_equal(tlab.lab_qmm_manual(xt, tqt, "dma", s_fmt, tk2).numpy(),
                                  jax_manual("dma"))


def test_lab_wrappers_refuse_what_they_do_not_take():
    _, tqt, _ = _weights("q4-sm")
    x = torch.zeros(1, int(tqt.shape[1]), dtype=torch.bfloat16)
    xi8 = torch.ones(1, int(tqt.shape[1]), dtype=torch.int8)
    with pytest.raises(ValueError):
        tlab.lab_qmm(x, xi8, tqt, "nope", "sm", 128)
    with pytest.raises(ValueError):
        tlab.lab_qmm(x, xi8, tqt, "full", "sp", 128)  # q4 has no sp layout
    with pytest.raises(ValueError):
        tlab.lab_qmm(x, xi8, tqt, "full", "sm", 128, geometry="m")
    _, q6, _ = _weights("q6w-sp")
    with pytest.raises(ValueError):
        tlab.lab_qmm_manual(x, q6, "full", "sp", 128)  # q4 only
    before = tlab.counter_k.plain_calls
    tlab.lab_qmm(x, xi8, tqt, "dma", "sm", 128)
    assert tlab.counter_k.plain_calls == before + 1


@pytest.mark.parametrize("mode,expect", [("dma", 256 * 256), ("full", 256 * 256 + 2 * 8 * 256 * 4)])
def test_lab_bytes(mode, expect):
    jqt, tqt, _ = _weights("q4-sm")  # K = 512: qs [256, 256] u8, sm [16, 256] f32
    assert tlab.lab_bytes(tqt, mode) == expect == jlab.lab_bytes(jqt, mode)


def test_time_chained_and_kernel_report_on_the_cpu():
    x = torch.ones(4, 8)
    t = attribution.time_chained(lambda xc: attribution.dep(xc, xc * 2.0), x, 4, reps=2)
    assert t > 0
    t2 = attribution.time_chained(lambda xc, w: attribution.dep(xc, xc @ w), x, 4, reps=1,
                                  aux=torch.eye(8))
    assert t2 > 0
    row = attribution.kernel_report("k", 1e-3, 3_350_000)
    assert set(row) == {"kernel", "us", "mb", "gbs", "hbm_frac", "mxu_frac"}
    assert abs(row["hbm_frac"] - 1e-3) < 1e-12 and abs(row["us"] - 1000.0) < 1e-9
    assert attribution.chain_length_for(10**12) == 32
    assert attribution.chain_length_for(1) == 2048
    # dep leaves the carry's values and dtype as they were
    c = torch.ones(3, dtype=torch.bfloat16)
    assert torch.equal(attribution.dep(c, torch.full((2,), 5.0)), c)


def test_profiling_on_the_cpu(tmp_path):
    profiling.device_sync(torch.ones(2))
    best, out = profiling.timed(lambda a: a + 1, torch.ones(3), reps=2)
    assert best > 0 and torch.equal(out, torch.full((3,), 2.0))
    with profiling.trace(tmp_path, "t"):
        torch.ones(8) @ torch.ones(8)
    assert json.loads((tmp_path / "t.json").read_text())


def test_roofline_bytes_match_reference(tmp_path):
    from tpu_kquant.models.fixtures import tiny_config, write_fixture_gguf
    from tpu_kquant.runtime.loader import load_model as jload
    from tpu_kquant.utils import roofline as jroof
    from tpu_kquant_torch.runtime.loader import load_model

    path = str(tmp_path / "tiny.gguf")
    write_fixture_gguf(path, tiny_config(n_layers=2, dim=256, n_heads=4, n_kv_heads=2,
                                         ffn_dim=512, vocab_size=512, max_seq_len=64),
                       seed=1, quant="q4_k_m", scale=0.05)
    cfg, pj, _ = jload(path, scale_dtype="bf16")
    _, pt, _ = load_model(path, scale_dtype="bf16", device="cpu")
    for batch in (1, 3):
        assert roofline.model_bytes_per_token(pt, batch) == jroof.model_bytes_per_token(pj, batch)
    assert roofline.matmul_flops_per_token(pt) == jroof.matmul_flops_per_token(pj)
    assert roofline.kv_bytes_per_token(cfg, 64, 2, True) == jroof.kv_bytes_per_token(
        cfg, 64, 2, True)
    rep = roofline.roofline_report(pt, cfg, 100.0, seq_len=64)
    assert rep["chip"] == "h100" and rep["roofline_tok_s"] == pytest.approx(
        3350e9 / (rep["weight_bytes"] + rep["kv_bytes"]))
    assert roofline.prefill_roofline_report(pt, cfg, 1e4, T=64)["bound"] in ("mxu", "hbm")


def test_kernel_lab_cli_runs_on_the_cpu(capsys):
    rows = t_lab_cli.main(["--model", "toy", "--tensor", "wqk,dn", "--modes", "dma,full",
                           "--tks", "64", "--tns", "128", "--reps", "1", "--manual",
                           "--device", "cpu"])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == rows
    # wqk (q4): 2 geometries x 2 modes + manual dma, full; dn (q6w): 2 x 2
    assert len(rows) == 10 and all(r["us"] > 0 and r["device"] == "cpu" for r in rows)
    assert {r["geometry"] for r in rows} == {"k", "n", "manual"}


@pytest.mark.parametrize("phase,extra", [("decode", ["--only", "head"]),
                                         ("prefill", ["--rows", "8"])])
def test_kernel_bench_cli_runs_on_the_cpu(capsys, phase, extra):
    rows = t_bench.main(["--model", "toy", "--phase", phase, "--iters", "2", "--device", "cpu",
                         *extra])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == rows
    assert rows and all(r["us"] > 0 and r["device"] == "cpu" for r in rows)


def test_clis_refuse_to_fall_back_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CLIs would run on it")
    with pytest.raises(RuntimeError):
        t_lab_cli.main(["--model", "toy"])
    with pytest.raises(RuntimeError):
        t_bench.main(["--model", "toy"])
