"""The port's weight-only quantization against the JAX package.

- `weight_quantize`, int8 and packed int4: the same payload bytes and the
  same f32 scales as paddle_tpu.ops.quant.weight_quantize, on seeded
  numpy weights (f32 and bf16, with an all-zero column); odd K raises
  for int4;
- `int4_planes` and `weight_dequantize`: identical to JAX's;
- `weight_only_linear` on CPU tensors (its plain version) against the JAX
  Pallas kernel (interpret mode on the CPU, as tests/test_fused_ops.py
  runs it) and the JAX reference, int8 and int4, f32 at 2e-5 (the two
  frameworks sum in other orders); N = 1000 (no multiple of 128: JAX pads
  it, the port's kernel masks it), M = 3, a bias, a 3-D x; its x-gradient
  against JAX's custom VJP at 2e-5; its route counters.

`TestWeightOnlyLinearOnCard` holds the CUDA kernel against the plain
version on the card; it skips without one. On the machine with the card,
which has no JAX: python -m pytest --noconftest tests/test_torch_quant.py
-m cuda. bf16 is held by relative errors (`rel_errors`) over the whole
output (limit 3e-4) and over each output row (1e-3, the row's norm
floored at 1% of the root-mean-square row norm), chip_smoke.py's limits:
the kernel and the plain version both round an f32 sum of exact bf16 x
q products to bf16, and the sums differ by summation order only, so an
output differs by at most one bf16 step (2^-8 relative) where the two
sums straddle a rounding boundary, which is rare; a wrong nibble order
or a lost sign extension moves every output, and so does a scale folded
into the bf16 weight, bf16(q s), by ~2^-9 a weight (`TestBarsCatchFaults`
reads all three on the CPU; quant_limits.py plants them in the kernel).
"""

import types

import numpy as np
import pytest
import torch

from paddle_tpu_torch import ops
from paddle_tpu_torch.ops import quant
from paddle_tpu_torch.ops.quant import (int4_bf16x2_bits, int4_planes,
                                        int8_bf16_bits, weight_dequantize,
                                        weight_only_linear,
                                        weight_only_linear_reference,
                                        weight_quantize)

INT8, INT4 = "weight_only_int8", "weight_only_int4"
BF16_TENSOR_LIMIT = 3e-4
BF16_ROW_LIMIT = 1e-3


def rel_errors(got, want):
    """(tensor, row) relative errors of `got` against `want` [..., N]:
    ||got - want|| / ||want|| over the whole output, and the largest of
    the same over its rows, each row's norm floored at 1% of the
    root-mean-square row norm."""
    w = want.float().reshape(-1, want.shape[-1])
    d = got.float().reshape(w.shape) - w
    wn, dn = w.norm(dim=-1), d.norm(dim=-1)
    floor = 1e-2 * float(w.norm()) / wn.numel() ** 0.5
    return (float(d.norm() / w.norm()),
            float((dn / wn.clamp_min(floor)).max()))


@pytest.fixture(scope="module")
def jx():
    """The JAX side, imported here so that the card-only class runs on a
    machine without JAX."""
    jax = pytest.importorskip("jax")
    from paddle_tpu.ops import quant as jq
    return types.SimpleNamespace(jax=jax, jnp=jax.numpy, q=jq)


def _weight(K, N, seed, zero_col=True):
    w = np.random.RandomState(seed).randn(K, N).astype(np.float32)
    if zero_col:
        w[:, 1] = 0.0                  # absmax 0: the 1e-8 floor divides
    w[0, 2] = 40.0                     # an outlier sets its column's scale
    return w


class TestWeightQuantize:
    @pytest.mark.parametrize("algo", [INT8, INT4])
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_bytes_and_scales_identical(self, jx, algo, dtype):
        w = _weight(24, 40, 0)
        jw = jx.jnp.asarray(w).astype(dtype)
        tw = torch.from_numpy(w).to(getattr(torch, dtype))
        jq, js = jx.q.weight_quantize(jw, algo)
        tq, ts = weight_quantize(tw, algo)
        assert tq.dtype == torch.int8 and ts.dtype == torch.float32
        assert tuple(tq.shape) == ((12, 40) if algo == INT4 else (24, 40))
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        assert (tq.numpy()[:, 1] == 0).all() and ts.numpy()[1] == 0.0

    def test_odd_k_raises_for_int4(self, jx):
        w = _weight(7, 8, 1)
        with pytest.raises(ValueError, match="even K"):
            jx.q.weight_quantize(jx.jnp.asarray(w), INT4)
        with pytest.raises(ValueError, match="even K"):
            weight_quantize(torch.from_numpy(w), INT4)
        # int8 takes any K
        assert tuple(weight_quantize(torch.from_numpy(w))[0].shape) == (7, 8)

    def test_unknown_algo_raises(self):
        with pytest.raises(ValueError, match="unknown algo"):
            weight_quantize(torch.zeros(4, 4), "weight_only_int2")

    @pytest.mark.parametrize("algo", [INT8, INT4])
    def test_planes_and_dequantize_identical(self, jx, algo):
        w = _weight(16, 24, 2)
        jq, js = jx.q.weight_quantize(jx.jnp.asarray(w), algo)
        tq, ts = _t(jq), _t(js)
        np.testing.assert_array_equal(
            weight_dequantize(tq, ts, algo).numpy(),
            np.asarray(jx.q.weight_dequantize(jq, js, algo)))
        if algo == INT4:
            for got, want in zip(int4_planes(tq), jx.q.int4_planes(jq)):
                assert got.dtype == torch.int8
                np.testing.assert_array_equal(got.numpy(), np.asarray(want))
            # every nibble value -7..7 round-trips through the packing
            lo, hi = int4_planes(tq)
            q = torch.clamp(torch.round(torch.from_numpy(w)
                                        / torch.clamp_min(ts, 1e-8)), -7, 7)
            np.testing.assert_array_equal(lo.numpy(), q[0::2].numpy())
            np.testing.assert_array_equal(hi.numpy(), q[1::2].numpy())


def _wol_case(M, K, N, algo, seed, bias=False, lead=()):
    rng = np.random.RandomState(seed)
    x = rng.randn(*lead, M, K).astype(np.float32)
    qw, s = weight_quantize(torch.from_numpy(
        rng.randn(K, N).astype(np.float32) * K ** -0.5), algo)
    b = rng.randn(N).astype(np.float32) if bias else None
    return x, qw.numpy(), s.numpy(), b


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


class TestWeightOnlyLinearParity:
    @pytest.mark.parametrize("algo", [INT8, INT4])
    @pytest.mark.parametrize("M,K,N,bias,lead", [
        (3, 16, 1000, True, ()),        # N no multiple of 128; a bias
        (5, 32, 48, False, (2,)),       # a 3-D x
        (8, 64, 256, False, ()),
    ])
    def test_matches_jax(self, jx, algo, M, K, N, bias, lead):
        x, qw, s, b = _wol_case(M, K, N, algo, 0, bias, lead)
        jargs = [jx.jnp.asarray(v) for v in (x, qw, s)]
        jb = None if b is None else jx.jnp.asarray(b)
        want = [jx.q.weight_only_linear(*jargs, jb, algo=algo),
                jx.q.weight_only_linear_reference(*jargs, jb, algo=algo)]
        before = weight_only_linear.plain_calls
        got = weight_only_linear(_t(x), _t(qw), _t(s), _t(b), algo=algo)
        assert weight_only_linear.plain_calls == before + 1
        assert tuple(got.shape) == (*lead, M, N)
        assert got.dtype == torch.float32
        for w in want:
            np.testing.assert_allclose(got.numpy(), np.asarray(w),
                                       atol=2e-5, rtol=2e-5)
        ref = weight_only_linear_reference(_t(x), _t(qw), _t(s), _t(b),
                                           algo=algo)
        torch.testing.assert_close(got, ref, rtol=0, atol=0)

    @pytest.mark.parametrize("algo", [INT8, INT4])
    def test_x_gradient_matches_jax_vjp(self, jx, algo):
        x, qw, s, _ = _wol_case(4, 32, 40, algo, 1, lead=(2,))
        g = np.random.RandomState(2).randn(2, 4, 40).astype(np.float32)
        jqw, js = jx.jnp.asarray(qw), jx.jnp.asarray(s)
        _, vjp = jx.jax.vjp(
            lambda v: jx.q.weight_only_linear(v, jqw, js, algo=algo),
            jx.jnp.asarray(x))
        want = np.asarray(vjp(jx.jnp.asarray(g))[0])
        tx = _t(x).requires_grad_()
        weight_only_linear(tx, _t(qw), _t(s), algo=algo).backward(_t(g))
        np.testing.assert_allclose(tx.grad.numpy(), want, atol=2e-5,
                                   rtol=2e-5)

    def test_counts_and_registry(self):
        reg = ops.oracles()["weight_only_linear"]
        assert reg.kernel is weight_only_linear
        assert reg.reference is weight_only_linear_reference
        ops.reset_counts()
        x, qw, s, _ = _wol_case(2, 16, 8, INT4, 3)
        weight_only_linear(_t(x), _t(qw), _t(s), algo=INT4)
        assert ops.launch_counts()["weight_only_linear"] == {
            "launches": 0, "plain_calls": 1}

    def test_bf16_on_cpu_rounds_once(self):
        # the plain version's bf16 output is the f32 product rounded once
        x, qw, s, _ = _wol_case(3, 32, 24, INT8, 4)
        xb = _t(x).to(torch.bfloat16)
        got = weight_only_linear(xb, _t(qw), _t(s))
        want = (xb.float() @ (_t(qw).float() * _t(s))).to(torch.bfloat16)
        torch.testing.assert_close(got, want, rtol=0, atol=0)

    def test_refuses_fp_and_unknown_layouts(self):
        x = torch.zeros(2, 8)
        with pytest.raises(ValueError, match="int8 or int4"):
            weight_only_linear(x, torch.zeros(8, 4), torch.ones(4), algo=None)
        with pytest.raises(ValueError, match="unknown algo"):
            weight_only_linear(x, torch.zeros(8, 4, dtype=torch.int8),
                               torch.ones(4), algo="int8")


class TestBarsCatchFaults:
    """The card tests' bf16 bars against the two faults an int4 loader
    can make, and against the scale folded into a bf16 weight: all read
    above them, the sound kernel's f32-exact products (bf16 x bf16 q,
    summed in f32) far below."""

    @staticmethod
    def _faulty(x, qw, s, fault):
        q = qw.to(torch.int32)
        lo, hi = ((q & 0xF) ^ 8) - 8, q >> 4
        if fault == "nibble_order_swapped":
            lo, hi = hi, lo
        else:                               # sign extension dropped
            lo, hi = q & 0xF, (q >> 4) & 0xF
        sf = s.float()[None]
        xf = x.float()
        return (xf[:, 0::2] @ (lo.float() * sf)
                + xf[:, 1::2] @ (hi.float() * sf)).to(x.dtype)

    @pytest.mark.parametrize("fault", ["nibble_order_swapped",
                                       "sign_extension_dropped"])
    @pytest.mark.parametrize("M,K,N", [(132, 512, 1024), (7, 256, 1000)])
    def test_faults_read_above_the_bars(self, fault, M, K, N):
        x, qw, s, _ = _wol_case(M, K, N, INT4, 5)
        xb = _t(x).to(torch.bfloat16)
        want = weight_only_linear_reference(xb, _t(qw), _t(s), algo=INT4)
        tensor, row = rel_errors(self._faulty(xb, _t(qw), _t(s), fault),
                                 want)
        assert tensor > 10 * BF16_TENSOR_LIMIT and row > 10 * BF16_ROW_LIMIT
        # a product whose f32 sum is taken in another order reads 0 or
        # one bf16 step on a few outputs
        other = (xb.float()
                 @ weight_dequantize(_t(qw), _t(s), INT4)).to(torch.bfloat16)
        tensor, row = rel_errors(other, want)
        assert tensor <= BF16_TENSOR_LIMIT and row <= BF16_ROW_LIMIT

    @pytest.mark.parametrize("algo", [INT8, INT4])
    @pytest.mark.parametrize("M,K,N", [(132, 512, 1024), (7, 256, 1000)])
    def test_folded_scale_reads_above_the_bars(self, algo, M, K, N):
        # bf16(q s) is another function than the f32 q s: each weight
        # moves by up to 2^-9 of itself, so most outputs round apart
        x, qw, s, _ = _wol_case(M, K, N, algo, 5)
        xb = _t(x).to(torch.bfloat16)
        want = weight_only_linear_reference(xb, _t(qw), _t(s), algo=algo)
        folded = weight_dequantize(_t(qw), _t(s), algo).to(torch.bfloat16)
        tensor, row = rel_errors((xb.float() @ folded.float()).to(
            torch.bfloat16), want)
        assert tensor > 3 * BF16_TENSOR_LIMIT and row > BF16_ROW_LIMIT


def _bf16_values(bits):
    """Float values of bf16 bit patterns (int32 tensor, low 16 bits)."""
    return ((bits & 0xFFFF) << 16).to(torch.int32).view(torch.float32)


class TestIntegerToBf16Bits:
    """The bf16 kernel's integer-to-bf16 conversions (csrc/wol_sm90.cu
    i4pair / i8pair, written out on int32 bit patterns in ops.quant) over
    every byte value: exactly the bf16 of int4_planes' nibbles and of the
    int8 value, nibble -8 and byte -128 included."""

    def test_int4_pairs_equal_the_planes(self):
        byte = torch.arange(256, dtype=torch.int32)
        bits = int4_bf16x2_bits(byte)
        lo, hi = int4_planes(quant._to_int8(byte)[:, None])
        for half, plane in ((bits, lo), (bits >> 16, hi)):
            want = plane[:, 0].float().to(torch.bfloat16).view(torch.int16)
            got = (half & 0xFFFF).to(torch.int32)
            assert torch.equal(got, want.to(torch.int32) & 0xFFFF)
            assert torch.equal(_bf16_values(half), plane[:, 0].float())
        assert set(lo[:, 0].tolist()) == set(range(-8, 8))

    def test_int8_bytes_equal_their_values(self):
        byte = torch.arange(256, dtype=torch.int32)
        value = quant._to_int8(byte).float()
        bits = int8_bf16_bits(byte)
        want = value.to(torch.bfloat16).view(torch.int16).to(torch.int32)
        assert torch.equal(bits, want & 0xFFFF)
        assert torch.equal(_bf16_values(bits), value)
        assert value.min() == -128 and value.max() == 127


# ------------------------------------------------------------ on the card
@pytest.mark.cuda
class TestWeightOnlyLinearOnCard:
    """The CUDA kernels against their plain version on the same inputs on
    the card: f32 at 2e-5 (summation order; the megakernels' GEMM core),
    bf16 by `rel_errors` (csrc/wol_sm90.cu). T = 132 rows is the 8B
    serving step's (one 136-row token tile in bf16, one 160-row tile in
    f32), 200 takes two; M = 5 the int4 LM head's decode rows; N = 1000
    takes byte copies of the rows and a ragged last column tile."""

    @pytest.fixture(autouse=True)
    def _card(self):
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA card: the kernel is CUDA C++ with no "
                        "CPU mode")
        torch.backends.cuda.matmul.allow_tf32 = False

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("algo", [INT8, INT4])
    @pytest.mark.parametrize("M,K,N,lead", [
        (132, 512, 1024, ()), (5, 1024, 4000, ()), (7, 256, 1000, ()),
        (200, 264, 136, ()), (3, 64, 40, (2,))])
    def test_kernel_against_plain(self, dtype, algo, M, K, N, lead):
        x, qw, s, _ = _wol_case(M, K, N, algo, 6, lead=lead)
        x = _t(x).cuda().to(dtype)
        qw, s = _t(qw).cuda(), _t(s).cuda()
        n = weight_only_linear.launches
        got = weight_only_linear(x, qw, s, algo=algo)
        torch.cuda.synchronize()
        assert weight_only_linear.launches == n + 1
        assert got.dtype == dtype and tuple(got.shape) == (*lead, M, N)
        want = weight_only_linear_reference(x, qw, s, algo=algo)
        assert bool(torch.isfinite(got).all())
        if dtype == torch.float32:
            torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)
        else:
            tensor, row = rel_errors(got, want)
            assert tensor <= BF16_TENSOR_LIMIT, tensor
            assert row <= BF16_ROW_LIMIT, row

    def test_bias_and_gradient(self):
        x, qw, s, b = _wol_case(4, 64, 48, INT4, 7, bias=True)
        x = _t(x).cuda().requires_grad_()
        qw, s, b = _t(qw).cuda(), _t(s).cuda(), _t(b).cuda()
        out = weight_only_linear(x, qw, s, b, algo=INT4)
        out.sum().backward()
        xc = x.detach().cpu().requires_grad_()
        ref = weight_only_linear(xc, qw.cpu(), s.cpu(), b.cpu(), algo=INT4)
        ref.sum().backward()
        torch.testing.assert_close(out.cpu(), ref.detach(), atol=2e-5,
                                   rtol=2e-5)
        torch.testing.assert_close(x.grad.cpu(), xc.grad, atol=2e-5,
                                   rtol=2e-5)

    def test_refuses_what_it_cannot_take(self):
        qw = torch.zeros(12, 16, dtype=torch.int8, device="cuda")
        s = torch.ones(16, device="cuda")
        with pytest.raises(ValueError, match="16-byte pieces"):
            weight_only_linear(torch.zeros(2, 12, device="cuda",
                                           dtype=torch.bfloat16), qw, s)
        with pytest.raises(ValueError, match="against"):
            weight_only_linear(torch.zeros(2, 16, device="cuda"), qw, s)

    @staticmethod
    def _random_bytes(algo, M, K, N, seed):
        """bf16 x [M, K] and a weight of random bytes (every int4 nibble,
        -8 included; int8 -128 included) with scales in [1e-3, 5e-2]."""
        g = torch.Generator(device="cuda").manual_seed(seed)
        x = torch.randn(M, K, device="cuda", generator=g).to(torch.bfloat16)
        rows = K // 2 if algo == INT4 else K
        qw = torch.randint(-128, 128, (rows, N), device="cuda", generator=g,
                           dtype=torch.int32).to(torch.int8)
        s = torch.rand(N, device="cuda", generator=g) * 0.049 + 1e-3
        return x, qw, s

    @pytest.mark.parametrize("algo", [INT8, INT4])
    @pytest.mark.parametrize("M,K,N", [
        (1, 512, 384), (4, 4096, 4096), (8, 264, 1000), (9, 200, 136),
        (257, 520, 640), (5, 256, 1004), (3, 128, 999)])
    def test_bf16_edges(self, algo, M, K, N):
        # token widths n8 / n16 and two token tiles (257 rows: 136 + 121),
        # a K split (4 x [4096 -> 4096]), N past the last 128-column box
        # (1000 and 136 also no whole 16-byte rows: 8-byte copies; 1004:
        # 4-byte; 999: single bytes and an odd output row), K past the
        # last 64-wide box (264, 200, 520), weights of random bytes
        x, qw, s = self._random_bytes(algo, M, K, N, M + K + N)
        n = weight_only_linear.launches
        got = weight_only_linear(x, qw, s, algo=algo)
        torch.cuda.synchronize()
        assert weight_only_linear.launches == n + 1
        want = weight_only_linear_reference(x, qw, s, algo=algo)
        assert bool(torch.isfinite(got).all())
        tensor, row = rel_errors(got, want)
        assert tensor <= BF16_TENSOR_LIMIT, tensor
        assert row <= BF16_ROW_LIMIT, row

    @pytest.mark.parametrize("algo", [INT8, INT4])
    @pytest.mark.parametrize("M,K,N", [(5, 256, 512), (4, 4096, 1024),
                                       (140, 256, 256)])
    def test_bf16_writes_no_row_past_m(self, algo, M, K, N):
        # the output as the first M rows of a NaN buffer: the rows after
        # them stay NaN (the token tile's rows past M are computed, on
        # zeros, and never stored), with and without a K split
        x, qw, s = self._random_bytes(algo, M, K, N, 11)
        big = torch.full((M + 136, N), float("nan"), device="cuda",
                         dtype=torch.bfloat16)
        got = quant._launch_bf16(x, qw, s, algo, big[:M])
        torch.cuda.synchronize()
        assert bool(torch.isnan(big[M:]).all())
        tensor, row = rel_errors(
            got, weight_only_linear_reference(x, qw, s, algo=algo))
        assert tensor <= BF16_TENSOR_LIMIT and row <= BF16_ROW_LIMIT

    @pytest.mark.parametrize("algo", [INT8, INT4])
    def test_bf16_past_the_map_cache(self, algo):
        # one x against 2048 weights at distinct addresses: twice the
        # tensor maps that wol_sm90.cu's cache holds (1024 in hashed
        # buckets of 4, a bucket that takes a fifth evicting one), so the
        # buckets, x's among them, take ~8 maps each and evict. Every
        # product has the bits of the same product through one reused
        # weight buffer (two maps in all, none evicted), and matches its
        # plain version ([4, 2048] outputs: a bf16 rounding flip of one
        # output moves the tensor's error by ~1e-4; at [4, 256] one flip
        # could pass 3e-4 alone)
        x, _, _ = self._random_bytes(algo, 4, 128, 2048, 3)
        weights = [self._random_bytes(algo, 4, 128, 2048, 100 + i)[1:]
                   for i in range(2048)]
        got = [weight_only_linear(x, qw, s, algo=algo) for qw, s in weights]
        buf = torch.empty_like(weights[0][0])
        alone = []
        for qw, s in weights:
            buf.copy_(qw)
            alone.append(weight_only_linear(x, buf, s, algo=algo))
        torch.cuda.synchronize()
        for out, one, (qw, s) in zip(got, alone, weights):
            assert torch.equal(out, one)
            tensor, row = rel_errors(
                out, weight_only_linear_reference(x, qw, s, algo=algo))
            assert tensor <= BF16_TENSOR_LIMIT, tensor
            assert row <= BF16_ROW_LIMIT, row


def test_module_names_its_queue_b_kernel():
    # int4_dequantize (the MLA whole read), once queue B's, is ported with
    # the MLA slice and held to JAX in tests/test_torch_deepseek.py
    entry = ops.oracles()["int4_dequantize"]
    assert entry.kernel is quant.int4_dequantize
    assert "int4_dequantize" in quant.__doc__
    assert entry.parity_test.startswith("tests/test_torch_deepseek.py")
