"""The benchmark's work arithmetic against shapes worked out by hand.

    python -m pytest fhe_bench -q -p no:cacheprovider
"""

import pytest

from fhe_bench import work as W

N = 1 << 15            # logN = 15
LOGN = 15


def test_ntt_cost_by_hand():
    # rows in and out plus the twiddle and Shoup tables of L limbs; one
    # Shoup product per butterfly.
    b, m = W.ntt_cost(22, 22, N)
    assert b == 4.0 * (2 * 22 * N + 2 * 22 * N)
    assert m == 22 * (N // 2) * LOGN * 3


def test_moddown_keyswitch_shape_by_hand():
    # [2, 30, N] -> [2, 22, N]: 8 special limbs dropped. Reads 60 rows,
    # writes 44; the iNTT of the 16 dropped rows with 8 limbs of tables,
    # the NTT of the 44 kept rows with 22 limbs of tables (their row traffic
    # is the read and the write already counted).
    b, m = W.moddown_cost(2, 22, 8, N)
    assert b == 4 * (60 * N + 44 * N) + 4 * 2 * 8 * N + 4 * 2 * 22 * N
    m_i = 16 * (N // 2) * LOGN * 3
    m_f = 44 * (N // 2) * LOGN * 3
    assert m == m_i + m_f + 16 * N * 3 + 44 * N * 9 * 7 + 44 * N * 3


def test_keyswitch_matches_the_single_row_formula():
    # chip_smoke's phase-2 formula at 22 limbs, 8 specials (3 digits of 8,
    # 30 key limbs): M = 1.
    L, D, A, J = 22, 3, 8, 30
    b, m = W.keyswitch_cost(1, L, D, A, J, N)
    b_i, m_i = W.ntt_cost(L, L, N)
    b_f, m_f = W.ntt_cost(D * J, J, N)
    words_io = L * N + 2 * D * J * N + 2 * J * N
    assert b == 4.0 * words_io + (b_i - 8.0 * L * N) + (b_f - 8.0 * D * J * N)
    assert m == (m_i + m_f + D * A * N * 3 + (D * J * A + 2 * D * J) * N * 7)
    # Two rows read the key once: less than twice one row's bytes.
    b2, m2 = W.keyswitch_cost(2, L, D, A, J, N)
    assert b < b2 < 2 * b
    assert m2 == pytest.approx(2 * m)


def test_bound_picks_the_binding_side():
    ms, by = W.bound(3.35e9, 1.0)
    assert ms == pytest.approx(1.0) and by == "bytes"
    ms, by = W.bound(1.0, 33.5e9)
    assert ms == pytest.approx(1.0) and by == "operations"
    assert W.kernel_time(3.35e9, 0.0) == pytest.approx(1e-3)


@pytest.mark.parametrize("level", [80, 79, 48, 17, 16, 3])
def test_digits_match_the_programs_tables(level):
    """D, A and J as the port's key-switch tables have them on the ResNet
    chain (16 special primes)."""
    from fhe_gpt2_tpu_torch import run_resnet
    from fhe_gpt2_tpu_torch.core.context import CkksContext
    a = run_resnet.parse_args(["--composite", "--logn", "10", "--levels",
                               "39", "--log-scale", "50", "--nsp", "16",
                               "--cpu"])
    ctx = CkksContext(run_resnet.make_params(a), device="cpu")
    ft = ctx.fused_ks_tables(level)
    D, A, J = W.digits(level, ctx.k_sp, ctx.k_sp)
    assert (D, A, J) == (ft.D, ft.A, len(ctx.key_limbs(level)))


def test_work_seconds_binds_on_the_larger_side():
    w = W.Work()
    w.add(3.35e12, 1.0)
    w.merge(w, times=1)
    assert w.seconds() == pytest.approx(2.0)
