"""Fused tau Gibbs sweep for the GPU: Pallas on the Triton route.

The XLA path (sampler.tau_sweep_xla) runs a fori_loop over the G strains
and, per strain, reads the counts and the [V,S,4] mixture and writes the
mixture back: G round trips through device memory plus several kernel
launches per strain. This kernel gives each program one block of positions
and keeps that block's counts and mixture in registers across ALL G strain
updates, then runs the strain-pair swap move (sampler.tau_swap_move) on the
same registers before writing once. Device-memory traffic per sweep drops to
one read of (n, mix, tau) and one write of (mix, tau).

Layout: n and mix stay in the sampler's own [V,S,4] layout. Each base plane
is a strided [BV, Sc] load (``ref[rows, samples, a]``), so no transpose or
padding copy is made per sweep. Ragged V, a sample count that is not a
power of two and G below its power of two are all handled with load/store
masks: masked samples and rows load zero counts, which are
likelihood-neutral (0 * log(floor) = 0), and are never stored. Samples are
processed in chunks of ``s_chunk`` lanes so that S=96 costs three 32-lane
chunks instead of one 128-lane block with a quarter masked off.

Randomness: the Gumbel noise and the swap proposal are drawn OUTSIDE the
kernel with the same ``fold_in`` streams as the XLA path, so both paths make
identical categorical draws up to float summation order of the candidate
scores (tests/test_pallas.py). The kernel does f32 multiply-adds and logs
only: no tensor-core contraction, so no TF32 rounding.

Reference parity: this replaces DESMAN's only native component, the
``sampletau`` Cython+GSL extension (SURVEY.md §2.1).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..utils import NBASES, safe_log

_LOG_FLOOR = 1e-12


def _next_pow2(x: int) -> int:
    return 1 << max(int(x) - 1, 0).bit_length()


def default_launch(S: int):
    """(block_rows, num_warps, s_chunk) for a sample count S.

    Chosen by the launch-shape sweep of ``chip_smoke.py --tune`` on an H100
    at V=1e4/S=64/G=8 and V=1e5/S=96/G=16: 8 rows x 8 warps x 32-lane
    sample chunks was fastest at the second shape and within 16 % of the
    fastest at the first (PERF.md "Tau kernel launch shape").
    """
    s_chunk = min(_next_pow2(S), 32)
    return 8, 8, s_chunk


def require_gpu(interpret: bool) -> None:
    """Refuse a compiled kernel call on a backend that cannot run it."""
    if interpret:
        return
    backend = jax.default_backend()
    if backend != "gpu":
        raise ValueError(
            f"the Pallas tau kernel is compiled for a GPU through Triton; "
            f"JAX's backend here is {backend!r}. Use --kernel xla, or pass "
            "interpret=True to run the kernel in the Pallas interpreter.")


def _kernel(n_ref, mix_ref, tau_ref, gz_ref, gam_ref, eta_ref, *refs,
            V: int, S: int, G: int, BV: int, Sc: int, Gp: int, swap: bool):
    """One full tau sweep (+ optional swap move) for rows [v0, v0+BV).

    n_ref, mix_ref: [V, S, 4]; tau_ref: [V, G] int32; gz_ref: [V, 4G]
    Gumbel noise (column g*4+c, already scaled by temperature); gam_ref:
    [S, G]; eta_ref: [4, 4]. With ``swap``: sel_ref [2] int32 (strains g,
    h) and logu_ref [V] (log-uniform thresholds pre-divided by beta).
    Outputs tau [V, G] and mix [V, S, 4] (aliased to the inputs).
    """
    if swap:
        sel_ref, logu_ref, tau_out_ref, mix_out_ref = refs
    else:
        tau_out_ref, mix_out_ref = refs
    K = -(-S // Sc)                                   # sample chunks
    pid = pl.program_id(0)
    v0 = pid * BV
    # chunk starts are traced so that the masked tail chunk (S % Sc != 0)
    # is not refused by the static out-of-bounds check on slices
    s0 = [pid * 0 + k * Sc for k in range(K)]
    rows = v0 + jnp.arange(BV)
    row_ok = rows < V
    lane = jnp.arange(Sc)
    s_ok = [k * Sc + lane < S for k in range(K)]
    m2 = [row_ok[:, None] & s_ok[k][None, :] for k in range(K)]

    def plane(ref, a, k):
        return plgpu.load(ref.at[pl.ds(v0, BV), pl.ds(s0[k], Sc), a],
                          mask=m2[k], other=0.0)

    def gamma_col(g, k):                               # [1, Sc]
        return plgpu.load(gam_ref.at[pl.ds(s0[k], Sc), g], mask=s_ok[k],
                          other=0.0)[None, :]

    n = [[plane(n_ref, a, k) for k in range(K)] for a in range(NBASES)]
    mix0 = tuple(plane(mix_ref, a, k)
                 for a in range(NBASES) for k in range(K))
    cols = jnp.arange(Gp)
    tau_mask = row_ok[:, None] & (cols[None, :] < G)
    tau0 = plgpu.load(tau_ref.at[pl.ds(v0, BV), pl.ds(0, Gp)], mask=tau_mask,
                      other=0)
    eta = [[eta_ref[a, b] for b in range(NBASES)] for a in range(NBASES)]

    def column(tau, g):                                # tau[:, g] -> [BV]
        return jnp.sum(jnp.where(cols[None, :] == g, tau, 0), axis=1)

    def logf(x):
        return jnp.log(jnp.maximum(x, _LOG_FLOOR))

    def strain(g, carry):
        mix_flat, tau = carry
        mix = [list(mix_flat[a * K:(a + 1) * K]) for a in range(NBASES)]
        tg = column(tau, g)[:, None]
        gam = [gamma_col(g, k) for k in range(K)]
        # remove strain g: rest[a] = mix[a] - gamma[s,g] * [tau[v,g] == a]
        rest = [[mix[a][k] - jnp.where(tg == a, gam[k], 0.0)
                 for k in range(K)] for a in range(NBASES)]
        # candidate c: sum_{s,b} n[b] * log(q[b] + gamma[s,g] eta[c,b]),
        # q[b] = sum_a rest[a] eta[a,b]
        cand = [0.0] * NBASES
        for k in range(K):
            q = [rest[0][k] * eta[0][b] + rest[1][k] * eta[1][b]
                 + rest[2][k] * eta[2][b] + rest[3][k] * eta[3][b]
                 for b in range(NBASES)]
            for c in range(NBASES):
                t = n[0][k] * logf(q[0] + gam[k] * eta[c][0])
                for b in range(1, NBASES):
                    t = t + n[b][k] * logf(q[b] + gam[k] * eta[c][b])
                cand[c] = cand[c] + jnp.sum(t, axis=1)
        # Gumbel-argmax (first maximum wins, as jnp.argmax)
        best = None
        new = jnp.zeros((BV,), jnp.int32)
        for c in range(NBASES):
            gz = plgpu.load(gz_ref.at[pl.ds(v0, BV), g * NBASES + c],
                            mask=row_ok, other=0.0)
            score = cand[c] + gz
            if best is None:
                best = score
            else:
                better = score > best
                best = jnp.where(better, score, best)
                new = jnp.where(better, c, new)
        new2 = new[:, None]
        mix = tuple(rest[a][k] + jnp.where(new2 == a, gam[k], 0.0)
                    for a in range(NBASES) for k in range(K))
        tau = jnp.where(cols[None, :] == g, new2, tau)
        return mix, tau

    mix_flat, tau = jax.lax.fori_loop(0, G, strain, (mix0, tau0))
    mix = [list(mix_flat[a * K:(a + 1) * K]) for a in range(NBASES)]

    if swap:
        # strain-pair swap (sampler.tau_swap_move): mix' = mix + dgam[s] *
        # d[v,a], so p' = p + dgam[s] * w[v,b] with w = d @ eta
        sg = sel_ref[0]
        sh = sel_ref[1]
        tg = column(tau, sg)
        th = column(tau, sh)
        d = [((th == a).astype(jnp.float32)
              - (tg == a).astype(jnp.float32))[:, None]
             for a in range(NBASES)]
        w = [d[0] * eta[0][b] + d[1] * eta[1][b] + d[2] * eta[2][b]
             + d[3] * eta[3][b] for b in range(NBASES)]
        dgam = [gamma_col(sg, k) - gamma_col(sh, k) for k in range(K)]
        dll = 0.0
        for k in range(K):
            t = None
            for b in range(NBASES):
                p = (mix[0][k] * eta[0][b] + mix[1][k] * eta[1][b]
                     + mix[2][k] * eta[2][b] + mix[3][k] * eta[3][b])
                tb = n[b][k] * (logf(p + dgam[k] * w[b]) - logf(p))
                t = tb if t is None else t + tb
            dll = dll + jnp.sum(t, axis=1)
        logu = plgpu.load(logu_ref.at[pl.ds(v0, BV)], mask=row_ok,
                          other=jnp.inf)
        acc = (logu < dll)[:, None]
        mix = [[mix[a][k] + jnp.where(acc, dgam[k] * d[a], 0.0)
                for k in range(K)] for a in range(NBASES)]
        tau = jnp.where(acc & (cols[None, :] == sg), th[:, None],
                        jnp.where(acc & (cols[None, :] == sh), tg[:, None],
                                  tau))

    plgpu.store(tau_out_ref.at[pl.ds(v0, BV), pl.ds(0, Gp)], tau,
                mask=tau_mask)
    for a in range(NBASES):
        for k in range(K):
            plgpu.store(mix_out_ref.at[pl.ds(v0, BV), pl.ds(s0[k], Sc), a],
                        mix[a][k], mask=m2[k])


def draw_gumbel(key, V: int, G: int, temp=1.0):
    """The sweep's categorical noise [V, G*4] — the same fold_in scheme as
    the XLA path. Split out so sharded callers can draw it globally (one
    partitionable-PRNG stream over the full V) before shard_mapping the
    kernel (parallel/sharded.py)."""
    return jnp.stack(
        [jax.random.gumbel(jax.random.fold_in(key, g), (V, NBASES))
         for g in range(G)], axis=1,
    ).reshape(V, G * NBASES) * temp


def draw_swap_proposal(key, V: int, G: int):
    """(g, h, logu[V]) with the exact stream sampler.tau_swap_move uses.

    G == 1 has no strain pair to swap; return a never-accept proposal
    (+inf thresholds, g == h) so direct callers stay safe.
    """
    if G < 2:
        return jnp.int32(0), jnp.int32(0), jnp.full((V,), jnp.inf, jnp.float32)
    k_pair, k_u = jax.random.split(key)
    g = jax.random.randint(k_pair, (), 0, G)
    off = jax.random.randint(jax.random.fold_in(k_pair, 1), (), 1, G)
    h = (g + off) % G
    logu = safe_log(jax.random.uniform(k_u, (V,)))
    return g, h, logu


def tau_sweep_pallas_from_gz(n, tau, mix, gamma, eta, gz, *, interpret=False,
                             swap_proposal=None, swap_beta=1.0,
                             block_rows=None, num_warps=None, s_chunk=None):
    """Kernel invocation with pre-drawn Gumbel noise ``gz`` [V, 4G].

    swap_proposal: optional pre-drawn (g, h, logu[V]) swap move, applied as
    the kernel's epilogue. Rows whose logu is +inf never accept.
    """
    require_gpu(interpret)
    V, S, _ = n.shape
    G = tau.shape[1]
    rows_d, warps_d, chunk_d = default_launch(S)
    BV = block_rows or rows_d
    Sc = s_chunk or chunk_d
    swap = swap_proposal is not None
    kernel = functools.partial(_kernel, V=V, S=S, G=G, BV=BV, Sc=Sc,
                               Gp=_next_pow2(G), swap=swap)
    args = [n.astype(jnp.float32), mix.astype(jnp.float32),
            tau.astype(jnp.int32), gz.astype(jnp.float32),
            gamma.astype(jnp.float32), eta.astype(jnp.float32)]
    if swap:
        g_s, h_s, logu = swap_proposal
        args += [jnp.stack([g_s, h_s]).astype(jnp.int32),
                 (logu / swap_beta).astype(jnp.float32)]
    tau_out, mix_out = pl.pallas_call(
        kernel,
        grid=(pl.cdiv(V, BV),),
        out_shape=[jax.ShapeDtypeStruct((V, G), jnp.int32),
                   jax.ShapeDtypeStruct((V, S, NBASES), jnp.float32)],
        input_output_aliases={2: 0, 1: 1},
        compiler_params=plgpu.CompilerParams(
            num_warps=num_warps or warps_d, num_stages=1),
        interpret=interpret,
        name="tau_sweep",
    )(*args)
    return tau_out, mix_out


def tau_sweep_pallas(n, tau, mix, gamma, eta, key, temp=1.0, *,
                     interpret=False, swap_key=None, swap_beta=1.0,
                     block_rows=None, num_warps=None, s_chunk=None):
    """Drop-in replacement for sampler.tau_sweep_xla (same signature/PRNG).

    swap_key (optional): run the strain-pair swap move (sampler.
    tau_swap_move semantics, same proposal stream) as the kernel's epilogue.
    make_sweep_fn uses this via the ``handles_swap`` attribute.
    ``interpret=True`` runs the kernel in the Pallas interpreter (CPU tests);
    otherwise the backend must be a GPU.
    """
    V, G = tau.shape
    gz = draw_gumbel(key, V, G, temp)
    swap_proposal = (None if swap_key is None
                     else draw_swap_proposal(swap_key, V, G))
    return tau_sweep_pallas_from_gz(
        n, tau, mix, gamma, eta, gz, interpret=interpret,
        swap_proposal=swap_proposal, swap_beta=swap_beta,
        block_rows=block_rows, num_warps=num_warps, s_chunk=s_chunk)


tau_sweep_pallas.handles_swap = True
