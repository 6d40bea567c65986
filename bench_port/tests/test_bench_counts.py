"""Operations and bytes at tiny shapes, worked by hand."""
import types

import pytest

import tiny  # noqa: F401
from bench_port import counts


def arch(**kw):
    base = dict(family="moe", n_layers=2, d_model=8, n_heads=4, n_kv_heads=2,
                dh=4, d_ff=6, n_experts=4, experts_per_token=2,
                vocab_size=10, rwkv_lora_dim=2)
    base.update(kw)
    return types.SimpleNamespace(**base)


def test_decoder_token():
    a = arch()
    # per layer: q 8*16 + k,v 2*8*8 + o 16*8 = 384; router 8*4 = 32;
    # 2 experts x 3 x 8 x 6 = 288; attention at pos 3: 2*4*4*4 = 128
    per = 2 * (384 + 32 + 288 + 2 * 4 * 4 * 4)
    assert counts.decoder_token_flops(a, 3) == 2 * per + 2 * 8 * 10
    d = arch(n_experts=0)
    assert counts.decoder_token_flops(d, 0) == \
        2 * 2 * (384 + 3 * 8 * 6 + 2 * 1 * 4 * 4) + 2 * 8 * 10


def test_rwkv_token():
    a = arch(family="rwkv", n_heads=2, dh=4)
    mm = 5 * 64 + 5 * 8 * 2 * 2 + 2 * 8 * 2 * 2 + 8 * 6 * 2 + 64
    assert counts.rwkv_token_flops(a) == 2 * (2 * mm + 7 * 2 * 16) + 2 * 8 * 10


def test_request_flops_leave_out_the_padding():
    a = arch()
    f = counts.request_flops(a, 3, 8, 2)
    assert f == sum(counts.decoder_token_flops(a, p) for p in (0, 1, 2, 8))


def test_paged_attention_call():
    a = arch(n_heads=4, n_kv_heads=2, dh=8)
    flops, nbytes = counts.paged_attention_call(a, rows=2, bucket=4, live=10,
                                                page=8)
    assert flops == 4 * 2 * 4 * 10 * 8
    kv = 2 * 10 * 2 * 8 * 2 * 2
    trash = 8 * 2 * 8 * 2 * 2
    qo = 4 * 4 * 8 * 2 * 2
    table = 2 * 2 * 4
    assert nbytes == kv + trash + qo + table


def test_wkv_call():
    a = arch(n_heads=2, dh=4)
    flops, nbytes = counts.wkv_call(a, rows=2)
    assert flops == 7 * 2 * 2 * 16
    assert nbytes == 2 * 2 * 16 * 4 * 2 + 2 * 2 * 4 * (6 + 4 + 4) + 2 * 4 * 4


def test_roofline_takes_the_larger_bound():
    bw = counts.PEAKS["hbm_bytes_per_s"]
    assert counts.roofline_s(0.0, bw, 1e12) == pytest.approx(1.0)
    assert counts.roofline_s(2e12, bw, 1e12) == pytest.approx(2.0)
