"""A pure-Python model of the cooperative Montgomery layer
(snark_setup_tpu_torch/ops/csrc/field_team.cuh), checked against Python-int
arithmetic.

On the card a team of T threads of one warp owns one field element of NL
32-bit limbs: thread t holds the K = NL / T limbs t*K .. t*K + K - 1 in its
registers. The model keeps one list of K words per thread and spells out
every step the header takes, in the same order: the operand word that
`__shfl_sync` broadcasts in each round, the per-thread 64-bit multiply-add
chains, the REDC quotient taken from thread 0 (one shuffle a round), the
shift of the window by one word (a shuffle from thread t + 1, the top thread
wrapping round to thread 0's word, which is 0), the pending carry word each
thread owes the next, its hand-over (from thread t - 1, thread 0 wrapping
round to the top thread's, which is 0) and the
carry-lookahead over the team's `__ballot_sync` bits. Every 64-bit sum is
asserted to fit, so a bound the CUDA code relies on fails here first.

The model is the rehearsal for the distributed carries: the CUDA header
follows it line for line and can only be compiled on the card. `mul_small`
and the weighted rows model the stacked product (K5) on the same layer, a
form measured on the H100 and kept off the path (PERF.md, ROADMAP.md Queue
B); the header has no copy of them. Each case
runs for NL 12 and 24 and every team size T the header could take (a power
of two dividing NL, at most 16), on the moduli of the curves the kernels
serve, with edge operands: 0, 1, N - 1, all-ones limbs, and values whose
carries ripple across every slice. Exact equality: integers mod N.
"""

import random

import pytest

from snark_setup_tpu_torch.curves.constants import get_curve

M32 = (1 << 32) - 1
MODULI = {  # NL 32-bit limbs -> the base-field moduli of the curves the kernels serve
    12: [get_curve("bls12_377").q, get_curve("bls12_381").q],
    24: [get_curve("bw6_761").q, get_curve("mnt4_753").q, get_curve("mnt6_753").q],
}
CASES = [(nl, t, q) for nl, qs in MODULI.items() for t in (2, 4, 8, 16) if nl % t == 0 for q in qs]


class Team:
    """One team's registers: `slices(v)` -> T lists of K words."""

    def __init__(self, NL: int, T: int, N: int):
        self.NL, self.T, self.K, self.N = NL, T, NL // T, N
        self.R = 1 << (32 * NL)
        self.n0 = (-pow(N, -1, 1 << 32)) % (1 << 32)
        self.n = self.slices(N)

    def slices(self, v: int) -> list[list[int]]:
        assert 0 <= v < self.R
        return [[(v >> (32 * (t * self.K + m))) & M32 for m in range(self.K)] for t in range(self.T)]

    def value(self, sl) -> int:
        return sum(w << (32 * (t * self.K + m)) for t, s in enumerate(sl) for m, w in enumerate(s))

    # -- shuffles and ballots ----------------------------------------------
    def shfl(self, words, src):  # __shfl_sync(FULL, x, src, T): every thread gets thread src's word
        return [words[src]] * self.T

    def shfl_next(self, words):  # __shfl_sync(FULL, x, t + 1, T): the top thread reads thread 0
        return words[1:] + words[:1]

    def shfl_prev(self, words):  # __shfl_sync(FULL, x, t - 1, T): thread 0 reads the top thread
        return words[-1:] + words[:-1]

    def lookahead(self, g, p):
        """team_lookahead: carry into each thread's slice and out of the
        team, from the ballots of g (a carry leaves the slice) and p (an
        incoming carry passes through it)."""
        assert not any(a and b for a, b in zip(g, p)), "g and p must exclude each other"
        G = sum(int(x) << t for t, x in enumerate(g))
        P = sum(int(x) << t for t, x in enumerate(p))
        c = ((G << 1) + P) ^ P
        return [(c >> t) & 1 for t in range(self.T)], (c >> self.T) & 1

    # -- slice-local chains --------------------------------------------------
    @staticmethod
    def slice_add_word(s, w):
        """s += w from the bottom word up; returns the carry out (0 or 1
        when w < 2^32)."""
        c = w
        for m in range(len(s)):
            c += s[m]
            assert c < 1 << 64
            s[m], c = c & M32, c >> 32
        return c

    @staticmethod
    def slice_sub_word(s, w):
        c = -w
        for m in range(len(s)):
            c += s[m]
            s[m], c = c & M32, c >> 32  # arithmetic shift: -1 while borrowing
        return -c

    def add_raw(self, a, b):
        """team_add_raw: a + b over the team; returns (slices, carry out)."""
        r, g, p = [], [], []
        for t in range(self.T):
            c, s = 0, []
            for m in range(self.K):
                c += a[t][m] + b[t][m]
                s.append(c & M32)
                c >>= 32
            r.append(s)
            g.append(c == 1)
            p.append(all(w == M32 for w in s))
        cin, top = self.lookahead(g, p)
        for t in range(self.T):
            self.slice_add_word(r[t], cin[t])
        return r, top

    def sub_raw(self, a, b):
        """team_sub_raw: a - b over the team; returns (slices, borrow out)."""
        r, g, p = [], [], []
        for t in range(self.T):
            c, s = 0, []
            for m in range(self.K):
                c += a[t][m] - b[t][m]
                s.append(c & M32)
                c >>= 32
            r.append(s)
            g.append(c == -1)
            p.append(all(w == 0 for w in s))
        bin_, top = self.lookahead(g, p)
        for t in range(self.T):
            self.slice_sub_word(r[t], bin_[t])
        return r, top

    def any_nonzero(self, a):
        return any(w for s in a for w in s)

    # -- field operations ----------------------------------------------------
    def cond_sub_n(self, a):
        d, borrow = self.sub_raw(a, self.n)
        return a if borrow else d

    def fadd(self, a, b):
        s, top = self.add_raw(a, b)
        assert top == 0
        return self.cond_sub_n(s)

    def fsub(self, a, b):
        d, borrow = self.sub_raw(a, b)
        r, _ = self.add_raw(d, self.n if borrow else self.slices(0))
        return r

    def fneg(self, a):
        d, _ = self.sub_raw(self.n, a)
        return d if self.any_nonzero(a) else self.slices(0)

    def mul_small(self, a, w):
        """team_mul_small: the exact w * a (< R), carries handed up one
        thread and resolved by the lookahead."""
        r, cout = [], []
        for t in range(self.T):
            c, s = 0, []
            for m in range(self.K):
                c += a[t][m] * w
                assert c < 1 << 64
                s.append(c & M32)
                c >>= 32
            r.append(s)
            cout.append(c)
        assert cout[-1] == 0, "the top thread carries nothing out (w a < R)"
        inc = self.shfl_prev(cout)
        g = [self.slice_add_word(r[t], inc[t]) == 1 for t in range(self.T)]
        p = [all(x == M32 for x in s) for s in r]
        cin, top = self.lookahead(g, p)
        assert top == 0
        for t in range(self.T):
            self.slice_add_word(r[t], cin[t])
        return r

    def mont(self, rows):
        """team_mont: (sum_r a_r b_r + M N) / R for the rows [(a, b), ...],
        interleaved (CIOS) over the team, then canonical. Returns the slices
        and the value before the conditional subtraction."""
        T, K = self.T, self.K
        A = [[0] * K for _ in range(T)]
        C = [0] * T
        for j in range(T):  # owner of the broadcast words
            for k in range(K):
                hi = list(C)  # what lands at weight t*K + K of each thread
                for a, b in rows:
                    bi = self.shfl([s[k] for s in b], j)[0]
                    for t in range(T):
                        c = 0
                        for m in range(K):
                            c += a[t][m] * bi + A[t][m]
                            assert c < 1 << 64
                            A[t][m], c = c & M32, c >> 32
                        hi[t] += c
                q = self.shfl([(A[t][0] * self.n0) & M32 for t in range(T)], 0)[0]
                for t in range(T):
                    c = 0
                    for m in range(K):
                        c += q * self.n[t][m] + A[t][m]
                        assert c < 1 << 64
                        A[t][m], c = c & M32, c >> 32
                    hi[t] += c
                assert A[0][0] == 0, "the quotient cancels the bottom word"
                nxt = self.shfl_next([A[t][0] for t in range(T)])  # the top thread gets that 0
                for t in range(T):
                    h = hi[t] + nxt[t]
                    assert h < 1 << 64
                    A[t] = A[t][1:] + [h & M32]
                    C[t] = h >> 32
                    assert C[t] < 1 << 32, "the pending carry is one 32-bit word"
        assert C[T - 1] == 0, "the value stays below R"
        inc = self.shfl_prev(C)  # thread 0 gets that 0
        g = [self.slice_add_word(A[t], inc[t]) == 1 for t in range(T)]
        p = [all(x == M32 for x in s) for s in A]
        cin, top = self.lookahead(g, p)
        assert top == 0
        for t in range(T):
            self.slice_add_word(A[t], cin[t])
        raw = self.value(A)
        return self.cond_sub_n(A), raw


def _edge_values(team: Team) -> list[int]:
    N, K, T = team.N, team.K, team.T
    ripple = (1 << (32 * K * (T - 1))) - 1  # all ones below the top slice: a carry crosses every boundary
    return [0, 1, 2, N - 1, N - 2, ripple % N, (ripple + 1) % N, (N >> 1) + 1, N - ripple % N]


def _randoms(N: int, n: int, seed: int) -> list[int]:
    rng = random.Random(seed)
    return [rng.randrange(N) for _ in range(n)]


@pytest.mark.parametrize("NL,T,N", CASES)
def test_lookahead_equals_a_ripple_carry_on_every_input(NL, T, N):
    team = Team(NL, T, N)
    for code in range(3 ** T):  # each thread: generates, propagates or neither
        g = [(code // 3 ** t) % 3 == 1 for t in range(T)]
        p = [(code // 3 ** t) % 3 == 2 for t in range(T)]
        cin, top = team.lookahead(g, p)
        c = 0
        for t in range(T):
            assert cin[t] == c, (g, p, t)
            c = int(g[t] or (p[t] and c))
        assert top == c


@pytest.mark.parametrize("NL,T,N", CASES)
def test_montgomery_product_equals_python_ints(NL, T, N):
    team = Team(NL, T, N)
    rinv = pow(team.R, -1, N)
    vals = _edge_values(team) + _randoms(N, 6, NL * T)
    for x in vals:
        for y in vals:
            got, raw = team.mont([(team.slices(x), team.slices(y))])
            assert raw < 2 * N
            assert team.value(got) == x * y * rinv % N, (x, y)
    # an operand of all-ones limbs (R - 1, not reduced) against the largest b
    got, raw = team.mont([(team.slices(team.R - 1), team.slices(N - 1))])
    assert raw < 2 * N and team.value(got) == (team.R - 1) * (N - 1) * rinv % N


@pytest.mark.parametrize("NL,T,N", CASES)
def test_shared_reduction_pair_equals_python_ints(NL, T, N):
    """fmul2: a1 b1 + a2 b2 under one reduction, as the group law's last
    three products."""
    team = Team(NL, T, N)
    rinv = pow(team.R, -1, N)
    vals = _edge_values(team)[:6] + _randoms(N, 3, 7 * NL + T)
    for a1, b1, a2, b2 in zip(vals, vals[::-1], vals[1:] + vals[:1], vals[2:] + vals[:2]):
        got, raw = team.mont([(team.slices(a1), team.slices(b1)), (team.slices(a2), team.slices(b2))])
        assert raw < 2 * N
        assert team.value(got) == (a1 * b1 + a2 * b2) * rinv % N
    top = N - 1
    got, _ = team.mont([(team.slices(top), team.slices(top))] * 2)
    assert team.value(got) == 2 * top * top * rinv % N


@pytest.mark.parametrize("NL,T,N", CASES)
def test_weighted_accumulation_at_the_towers_largest_weights(NL, T, N):
    """The stacked product on the team layer: rows w_r * u_r (exact, by
    `mul_small`) times v_r under one reduction, at the largest weight sum
    the towers use (3 x 14 = 42, the MNT4-753 Fp2 a != 0 round) and at six
    rows."""
    team = Team(NL, T, N)
    rinv = pow(team.R, -1, N)
    for weights in ((14, 14, 14), (13, 11, 7, 5, 3, 3), (1,), (42,)):
        if sum(weights) * N >= team.R:
            continue  # the wrapper refuses these weights (check_weights)
        for seed, edge in ((1, None), (2, N - 1), (3, 0)):
            us = _randoms(N, len(weights), seed * NL + T)
            vs = _randoms(N, len(weights), seed * NL + T + 1)
            if edge is not None:
                us[0] = vs[-1] = edge
            rows = [(team.mul_small(team.slices(u), w), team.slices(v)) for u, v, w in zip(us, vs, weights)]
            for (wu, _), u, w in zip(rows, us, weights):
                assert team.value(wu) == w * u
            got, raw = team.mont(rows)
            assert raw < 2 * N
            want = sum(w * u * v for u, v, w in zip(us, vs, weights)) * rinv % N
            assert team.value(got) == want, weights


@pytest.mark.parametrize("NL,T,N", CASES)
def test_additions_subtractions_and_negation_equal_python_ints(NL, T, N):
    team = Team(NL, T, N)
    vals = _edge_values(team) + _randoms(N, 4, 3 * NL + T)
    for x in vals:
        sx = team.slices(x)
        assert team.value(team.fneg(sx)) == (-x) % N
        for y in vals:
            sy = team.slices(y)
            assert team.value(team.fadd(sx, sy)) == (x + y) % N, (x, y)
            assert team.value(team.fsub(sx, sy)) == (x - y) % N, (x, y)
        for w in (1, 3, 4, 12):  # |3b| of the curves in scope, by addition chains on the card
            acc, addend, have = None, sx, False
            k = w
            while k:
                if k & 1:
                    acc = team.fadd(acc, addend) if have else addend
                    have = True
                k >>= 1
                if k:
                    addend = team.fadd(addend, addend)
            assert team.value(acc) == w * x % N
