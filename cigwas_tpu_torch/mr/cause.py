"""CAUSE: MR accounting for correlated and uncorrelated pleiotropy.

Native port of the benchmark's last competitor method (`run_cause_on_tr`,
`simulation/run_mr.R:97-135`, which drives the `cause` R
package: `est_cause_params` then `cause()` per ordered trait pair).

Model (Morrison et al. 2020, Nat Genet): for variant j with GWAS summary
stats (bh1, se1) on the exposure and (bh2, se2) on the outcome,

    bh_j ~ N2( (b1j, c_j * b1j + theta_j), S_j ),   S_j = [[se1^2, rho*se1*se2],
                                                           [rho*se1*se2, se2^2]]
    c_j  = gamma + eta * Z_j,   Z_j ~ Bernoulli(q)
    (b1j, theta_j) ~ sum_k pi_k N(0, s1k^2) x N(0, s2k^2)   (grid mixture)

gamma is the causal effect, eta the correlated-pleiotropy effect acting on
the Z-subset, theta uncorrelated pleiotropy. Marginally over (b1, theta):

    f_j(c) = sum_k pi_k N2(bh_j; 0, [[s1k^2+se1^2, c*s1k^2 + rho se1 se2],
                                     [  ...      , c^2 s1k^2 + s2k^2 + se2^2]])
    L_j(gamma, eta, q) = (1-q) f_j(gamma) + q f_j(gamma + eta)

`est_cause_params` fits (rho, pi) under gamma=eta=0 by EM + 1-D rho search
(the R package's penalized EM, `cause::est_cause_params`). `cause_fit`
computes grid posteriors for the SHARING model (gamma=0; eta, q free) and
the CAUSAL model (gamma, eta, q free) under the package's default priors
gamma, eta ~ N(0, 0.6^2), q ~ Beta(1, 10), and compares them by the
difference in pointwise posterior-predictive log densities:

    delta_j = elpd_j(sharing) - elpd_j(causal)
    z = sum(delta) / (sqrt(n) * sd(delta)),   p = Phi(z)

which is the R package's `loo`-based elpd contrast with the in-sample
posterior predictive in place of PSIS-LOO (documented divergence: PSIS
reweighting shifts elpd by O(p_eff/n); with n_iv variants >> the 3-d
parameter grid the rank ordering is stable). The fixed parameter grid
replaces the package's adaptive refinement (second documented divergence);
the grid is fine enough that posterior quantiles move < the reporting
precision of `run_mr.R`'s output table.

run_mr.R consumes exactly: the posterior median of gamma
(`m_s$quants[[2]][1,1]`) and the sharing-vs-causal p-value (`m_s$p`)
per (exposure tr1, outcome tr2) with IVs = SNPs associated with tr1.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

# parameter grids: c-grid spans the N(0, 0.6^2) prior's +-5 sd; eta/gamma
# values are snapped to it so L(gamma, eta, q) only ever evaluates f_j on
# the 1-D c-grid (gamma + eta must land back on the grid)
C_GRID = np.linspace(-3.0, 3.0, 121)  # step 0.05
Q_GRID = np.linspace(0.0, 1.0, 41)  # step 0.025
PRIOR_SD = 0.6
Q_ALPHA, Q_BETA = 1.0, 10.0


def _log_bvn(bh1, bh2, v1, v2, cv):
    """Elementwise log N2((bh1, bh2); 0, [[v1, cv], [cv, v2]])."""
    det = v1 * v2 - cv * cv
    det = np.maximum(det, 1e-300)
    quad = (v2 * bh1 * bh1 - 2 * cv * bh1 * bh2 + v1 * bh2 * bh2) / det
    return -0.5 * (np.log(det) + quad) - np.log(2 * np.pi)


def make_grid(bh1, se1, bh2, se2, n_sigma: int = 10):
    """Variance-pair grid (K, 2) like `cause::est_cause_params`' mix grid:
    a geometric ladder from below the median SE to the largest effect, all
    pairings, plus the (0, 0) null component."""
    def ladder(bh, se):
        lo = float(np.median(se)) / 10
        hi = max(float(np.abs(bh).max()), lo * 2)
        return np.concatenate([[0.0], np.geomspace(lo, hi, n_sigma)]) ** 2

    s1 = ladder(bh1, se1)
    s2 = ladder(bh2, se2)
    g1, g2 = np.meshgrid(s1, s2, indexing="ij")
    return np.stack([g1.ravel(), g2.ravel()], axis=1)


@dataclass
class CauseParams:
    rho: float
    grid: np.ndarray  # (K, 2) variance pairs
    pi: np.ndarray  # (K,) mixing proportions


def _null_loglik_components(bh1, se1, bh2, se2, grid, rho):
    """(n, K) log N2 under gamma=eta=0 for every grid component."""
    v1 = grid[:, 0][None, :] + (se1 * se1)[:, None]
    v2 = grid[:, 1][None, :] + (se2 * se2)[:, None]
    cv = (rho * se1 * se2)[:, None] * np.ones_like(grid[:, 0])[None, :]
    return _log_bvn(bh1[:, None], bh2[:, None], v1, v2, cv)


def est_cause_params(bh1, se1, bh2, se2, max_iter: int = 200,
                     tol: float = 1e-7) -> CauseParams:
    """Fit (rho, pi) under the null by EM with a golden-section rho search
    (`cause::est_cause_params`; run_mr.R:124)."""
    bh1, se1, bh2, se2 = (np.asarray(v, float) for v in (bh1, se1, bh2, se2))
    grid = make_grid(bh1, se1, bh2, se2)
    K = grid.shape[0]
    pi = np.full(K, 1.0 / K)
    rho = 0.0

    def loglik(rho_, pi_):
        lc = _null_loglik_components(bh1, se1, bh2, se2, grid, rho_)
        m = lc.max(axis=1, keepdims=True)
        return float(
            (m[:, 0] + np.log(np.exp(lc - m) @ pi_ + 1e-300)).sum()
        )

    last = -np.inf
    for _ in range(max_iter):
        # E + M step for pi
        lc = _null_loglik_components(bh1, se1, bh2, se2, grid, rho)
        m = lc.max(axis=1, keepdims=True)
        w = np.exp(lc - m) * pi[None, :]
        w /= w.sum(axis=1, keepdims=True) + 1e-300
        pi = w.mean(axis=0)
        pi = np.maximum(pi, 0)
        pi /= pi.sum()
        # 1-D rho maximization (bounded golden section)
        from scipy.optimize import minimize_scalar

        res = minimize_scalar(
            lambda r: -loglik(r, pi), bounds=(-0.99, 0.99), method="bounded",
            options={"xatol": 1e-4},
        )
        rho = float(res.x)
        cur = -float(res.fun)
        if abs(cur - last) < tol * max(1.0, abs(cur)):
            break
        last = cur
    return CauseParams(rho=rho, grid=grid, pi=pi)


def _f_on_cgrid(bh1, se1, bh2, se2, params: CauseParams):
    """(n, C) log f_j(c) for every c on C_GRID (mixture marginal over the
    variance grid at slope c)."""
    grid, pi, rho = params.grid, params.pi, params.rho
    s1k = grid[:, 0]  # (K,)
    s2k = grid[:, 1]
    n = bh1.shape[0]
    out = np.empty((n, C_GRID.size))
    se12 = se1 * se1
    se22 = se2 * se2
    rse = rho * se1 * se2
    for ci, c in enumerate(C_GRID):
        v1 = s1k[None, :] + se12[:, None]
        v2 = (c * c) * s1k[None, :] + s2k[None, :] + se22[:, None]
        cv = c * s1k[None, :] + rse[:, None]
        lc = _log_bvn(bh1[:, None], bh2[:, None], v1, v2, cv)
        m = lc.max(axis=1)
        out[:, ci] = m + np.log(np.exp(lc - m[:, None]) @ pi + 1e-300)
    return out


@dataclass
class CauseFit:
    gamma_median: float
    gamma_q: tuple  # (2.5%, 50%, 97.5%)
    eta_median: float
    q_median: float
    p_value: float  # sharing-vs-causal elpd contrast, Phi(z)
    z: float
    elpd_sharing: float
    elpd_causal: float
    params: CauseParams = field(repr=False, default=None)


def cause_fit(bh1, se1, bh2, se2, params: CauseParams | None = None) -> CauseFit:
    """Sharing- and causal-model grid posteriors + elpd comparison
    (`cause::cause` + `summary`, run_mr.R:125-133)."""
    from scipy.stats import beta as beta_dist, norm

    bh1, se1, bh2, se2 = (np.asarray(v, float) for v in (bh1, se1, bh2, se2))
    if params is None:
        params = est_cause_params(bh1, se1, bh2, se2)
    logf = _f_on_cgrid(bh1, se1, bh2, se2, params)  # (n, C)
    n, C = logf.shape

    # priors on the snapped grids
    lp_c = norm.logpdf(C_GRID, 0.0, PRIOR_SD)
    q_in = np.clip(Q_GRID, 1e-9, 1 - 1e-9)
    lp_q = beta_dist.logpdf(q_in, Q_ALPHA, Q_BETA)

    zero_ci = int(np.argmin(np.abs(C_GRID)))  # c = 0 cell
    # per-variant scaling keeps exp() in range: logf rows are shifted by
    # their max before exponentiation (cancels in both lj and pred)
    shift = logf.max(axis=1, keepdims=True)  # (n, 1)
    f = np.exp(logf - shift)  # (n, C)
    q = Q_GRID[None, None, :]  # (1, 1, Q)

    def cell_mix(gci):
        """(n, C, Q) mixture likelihood (shifted) for gamma cell gci over
        (eta, q), with out-of-grid gamma+eta cells marked by a 0 column.
        idx(gamma_i + eta_j) = gci + j - zero_ci on the uniform grid."""
        sum_idx = gci + np.arange(C) - zero_ci
        ok = (sum_idx >= 0) & (sum_idx < C)
        f1 = f[:, np.clip(sum_idx, 0, C - 1)]  # (n, C)
        mix = (1 - q) * f[:, gci][:, None, None] + q * f1[:, :, None]
        return mix, ok

    def fit(gamma_cells):
        """Grid posterior over (gamma_cells, eta, q): returns the
        normalized weights (G, C, Q) and the pointwise posterior
        predictive log density (n,). Two passes keep memory at one
        (n, C, Q) slab."""
        G = len(gamma_cells)
        lj = np.full((G, C, Q_GRID.size), -np.inf)
        for gi, gci in enumerate(gamma_cells):
            mix, ok = cell_mix(gci)
            with np.errstate(divide="ignore"):
                ll = np.log(mix + 1e-300).sum(axis=0)  # (C, Q)
            ll[~ok, :] = -np.inf
            lj[gi] = ll + lp_c[gci] + lp_c[:, None] + lp_q[None, :]
        m = lj.max()
        w = np.exp(lj - m)
        w /= w.sum()
        pred = np.zeros(n)
        for gi, gci in enumerate(gamma_cells):
            if w[gi].max() < 1e-12:
                continue
            mix, _ = cell_mix(gci)
            pred += np.einsum("ncq,cq->n", mix, w[gi], optimize=True)
        elpd_pw = np.log(pred + 1e-300) + shift[:, 0]
        return w, elpd_pw

    # SHARING: gamma fixed at 0
    w_s, elpd_s = fit([zero_ci])
    # CAUSAL: gamma over the grid
    gamma_cells = list(range(C))
    w_c, elpd_c = fit(gamma_cells)

    # gamma posterior quantiles (causal model)
    pg = w_c.sum(axis=(1, 2))
    cdf = np.cumsum(pg)
    qs = [float(np.interp(t, cdf, C_GRID)) for t in (0.025, 0.5, 0.975)]
    # eta / q medians (causal model)
    pe = w_c.sum(axis=(0, 2))
    pq = w_c.sum(axis=(0, 1))
    eta_med = float(np.interp(0.5, np.cumsum(pe), C_GRID))
    q_med = float(np.interp(0.5, np.cumsum(pq), Q_GRID))

    # elpd contrast (loo convention, `cause` elpd table row
    # sharing-vs-causal): delta_j = elpd_j(sharing) - elpd_j(causal);
    # z = sum / (sqrt(n) sd); causal better => delta < 0 => z < 0 =>
    # p = pnorm(z) small (matches run_mr.R:127 `pnorm(m$elpd[3, 5])`)
    delta = elpd_s - elpd_c
    sd = float(delta.std(ddof=1))
    z = float(delta.sum() / (np.sqrt(n) * sd)) if sd > 0 else 0.0
    p = float(norm.cdf(z))
    return CauseFit(
        gamma_median=qs[1],
        gamma_q=tuple(qs),
        eta_median=eta_med,
        q_median=q_med,
        p_value=p,
        z=z,
        elpd_sharing=float(elpd_s.sum()),
        elpd_causal=float(elpd_c.sum()),
        params=params,
    )


def run_cause_analyses(g_it, effects, ses, min_ivs: int = 2):
    """The benchmark's CAUSE loop (`run_cause_on_tr`, run_mr.R:97-135):
    for every ordered trait pair, IVs are the SNPs associated with the
    exposure; rows are (exposure, outcome, gamma_median, p)."""
    g_it = np.asarray(g_it).astype(bool)
    m, p = g_it.shape
    out = []
    for tr1 in range(p):
        ivs = np.where(g_it[:, tr1])[0]
        if len(ivs) < min_ivs:
            continue
        for tr2 in range(p):
            if tr1 == tr2:
                continue
            fit = cause_fit(
                effects[ivs, tr1], ses[ivs, tr1],
                effects[ivs, tr2], ses[ivs, tr2],
            )
            out.append((tr1, tr2, fit.gamma_median, fit.p_value, fit))
    return out
