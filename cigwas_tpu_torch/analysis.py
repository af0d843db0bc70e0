"""Downstream analysis of merged cusk/PAG outputs (`cigwas_tpu.analysis`;
the `bdpc.py` core), host numpy without pandas: the two association tables
are lists of dicts (one per row, the JAX function's DataFrame columns as
keys) and read the `.bim` with :func:`cigwas_tpu_torch.io.tables.read_columns`.
matplotlib is imported inside the plot helpers only.

Equivalent of the analysis layer of `cusk/scripts/bdpc.py` (reference
lines cited per function): pleiotropy matrices/sets over block skeletons,
PAG parent/causal-path extraction, edge-type tallies, marker-phenotype
association tables, and the generic heatmap/PAG/ACE plot helpers those
feed. The reference's paper-figure functions (its
`plot_*_figure_*` / simulation-performance suites, ~5 kLoC of hard-coded
cluster paths) are deliberately out of scope — they reproduce specific
publication figures, not pipeline capability.

Graph traversals are vectorized frontier sweeps over dense boolean
adjacency (numpy) instead of the reference's per-node `queue.Queue`
walks; results are identical sets.

Index conventions follow the reference: block-level and merged sparse
indices are 1-based with traits at 1..P (`BASE_INDEX`); PAG matrices are
0-based with traits leading. PAG endpoint marks: 1 = circle, 2 = arrow,
3 = tail (`pag/rfci.py`).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from cigwas_tpu_torch.io.tables import read_columns
from cigwas_tpu_torch.merge.merge_blocks import (
    BASE_INDEX, BlockOutput, block_stems_from_blockfile, merge_block_outputs,
)


def get_pheno_codes(phen_path: str) -> list[str]:
    """Trait names from a .phen header (bdpc.py:384-387)."""
    with open(phen_path) as fin:
        header = fin.readline()
    return header.strip().split("\t")[2:]


def _load_mtx_dense(path: str) -> np.ndarray:
    from scipy.io import mmread

    return np.asarray(mmread(path).todense())


# ---------------------------------------------------------------------------
# block-level parent / ancestor sets and pleiotropy (bdpc.py:747-920)
# ---------------------------------------------------------------------------


def _block_adj(bo: BlockOutput) -> np.ndarray:
    n = bo.num_markers() + bo.num_phen()
    return (
        np.fromfile(bo.basepath + ".adj", dtype=np.int32).reshape(n, n) != 0
    )


def _sparse_marker_ixs(bo: BlockOutput) -> np.ndarray:
    first = bo.num_phen() + bo.marker_offset
    return np.arange(first, first + bo.num_markers()) + BASE_INDEX


def block_pheno_parents(bo: BlockOutput, max_depth=np.inf) -> dict:
    """Markers reachable from each phenotype through marker-only paths
    within `max_depth` hops — the upper bound of markers that could
    affect it (`BlockOutput.pheno_parents`, bdpc.py:816-841).

    Keys are 1-based sparse phenotype indices; values are sets of sparse
    marker indices.
    """
    adj = _block_adj(bo)
    num_m, num_p = bo.num_markers(), bo.num_phen()
    # dense layout: markers 0..num_m-1, phens num_m..num_m+num_p-1
    marker_mask = np.zeros(num_m + num_p, bool)
    marker_mask[:num_m] = True
    sm_marker = _sparse_marker_ixs(bo)
    res = {}
    for p in range(num_p):
        visited = np.zeros(num_m + num_p, bool)
        frontier = np.zeros(num_m + num_p, bool)
        frontier[num_m + p] = True
        depth = 0
        while depth < max_depth and frontier.any():
            nxt = adj[frontier].any(axis=0) & marker_mask & ~visited
            if not nxt.any():
                break
            visited |= nxt
            frontier = nxt
            depth += 1
        res[p + BASE_INDEX] = set(sm_marker[visited[:num_m]].tolist())
    return res


def block_pheno_direct_parents(bo: BlockOutput) -> dict:
    """Markers directly adjacent to each phenotype
    (`BlockOutput.pheno_direct_parents`, bdpc.py:864-873)."""
    return block_pheno_parents(bo, max_depth=1)


def block_pheno_ancestor_sets(bo: BlockOutput, depth: int) -> dict:
    """Markers adjacent to each phenotype plus (for depth >= 2) their
    marker neighbours (`BlockOutput.pheno_ancestor_sets`,
    bdpc.py:843-862).

    QUIRK reproduced: the reference's inner walk never swaps its queues
    (bdpc.py:852-860 drains `q` once and `next_q` is never promoted), so
    any depth >= 2 reaches exactly TWO marker hops — not `depth`.
    """
    return block_pheno_parents(bo, max_depth=1 if depth <= 1 else 2)


def _pleiotropy_counts(pm: dict, diag: str) -> dict:
    """Shared-parent-marker counts per trait pair from per-trait parent
    sets; diag = "exclusive" (parents in no intersection,
    bdpc.py:875-888) or "union" (all parents, bdpc.py:890-905)."""
    phens = sorted(pm)
    pleio: set = set()
    res = {}
    for a, i in enumerate(phens):
        for j in phens[a + 1:]:
            s = pm[i] & pm[j]
            res[(i, j)] = len(s)
            res[(j, i)] = len(s)
            pleio.update(s)
    for i in phens:
        res[(i, i)] = len(pm[i] - pleio) if diag == "exclusive" else len(pm[i])
    return res


def _iter_blocks(blockfile: str, outdir: str):
    if not outdir.endswith("/"):
        outdir += "/"
    marker_offset = 0
    first = True
    for stem in block_stems_from_blockfile(blockfile):
        try:
            bo = BlockOutput(outdir + stem, marker_offset)
        except FileNotFoundError:
            if first:
                raise
            continue
        first = False
        marker_offset += bo.num_markers()
        yield bo


def global_epm(blockfile: str, outdir: str, max_depth=np.inf) -> dict:
    """Exclusive pleiotropy matrix over all blocks (bdpc.py:589-610):
    {(i, j): shared-parent count} with per-block marker offsets chained;
    missing block outputs are skipped like the reference's."""
    epm: dict = {}
    for bo in _iter_blocks(blockfile, outdir):
        for k, v in _pleiotropy_counts(
            block_pheno_parents(bo, max_depth), "exclusive"
        ).items():
            epm[k] = epm.get(k, 0) + v
    return epm


def global_upm(blockfile: str, outdir: str, max_depth=np.inf) -> dict:
    """Union pleiotropy matrix over all blocks (bdpc.py:566-587)."""
    upm: dict = {}
    for bo in _iter_blocks(blockfile, outdir):
        for k, v in _pleiotropy_counts(
            block_pheno_parents(bo, max_depth), "union"
        ).items():
            upm[k] = upm.get(k, 0) + v
    return upm


def global_eps(blockfile: str, outdir: str, max_depth=np.inf) -> dict:
    """Exclusive pleiotropy SETS over all blocks (bdpc.py:612-629):
    {(i, j): sparse marker indices shared by traits i, j} and
    {(i, i): markers exclusive to trait i}.

    DIVERGENCE: missing non-first block outputs are skipped (like
    global_epm/global_upm and the merge); the reference's global_eps has
    no try/except and raises FileNotFoundError there (bdpc.py:612-629).
    """
    eps: dict = {}
    for bo in _iter_blocks(blockfile, outdir):
        pm = block_pheno_parents(bo, max_depth)
        phens = sorted(pm)
        pleio: set = set()
        block: dict = {}
        for a, i in enumerate(phens):
            for j in phens[a + 1:]:
                s = pm[i] & pm[j]
                block[(i, j)] = s
                block[(j, i)] = s
                pleio.update(s)
        for i in phens:
            block[(i, i)] = pm[i] - pleio
        for k, v in block.items():
            if k in eps:
                eps[k] = eps[k] | v
            else:
                eps[k] = set(v)
    return eps


def global_parent_sets(
    blockfile: str, outdir: str, reduced_indices: bool = False
) -> dict:
    """Direct parent markers per phenotype across blocks
    (bdpc.py:659-681); with reduced_indices=False values are .bim row
    indices (mapped through the merged gmi), else sparse indices.

    QUIRK reproduced: the reference seeds the result with the FIRST
    block's sets before its mapping loop, so that block's values stay
    sparse indices even when reduced_indices=False (bdpc.py:665-669;
    same shape in global_ancestor_sets, bdpc.py:638-642).

    DIVERGENCE: missing non-first block outputs are skipped; the
    reference's global_parent_sets has no try/except and raises
    FileNotFoundError there (bdpc.py:659-681).
    """
    gmi = None
    if not reduced_indices:
        gmi = merge_block_outputs(blockfile, outdir).gmi
    res: dict = {}
    for idx, bo in enumerate(_iter_blocks(blockfile, outdir)):
        for k, v in block_pheno_direct_parents(bo).items():
            if gmi is not None and idx > 0:
                v = {int(gmi[ix]) for ix in v}
            res.setdefault(k, set()).update(v)
    return res


def global_ancestor_sets(
    blockfile: str, outdir: str, reduced_indices: bool = False, depth: int = 1
) -> dict:
    """Ancestor markers per phenotype across blocks (bdpc.py:631-657);
    see `block_pheno_ancestor_sets` for the reproduced depth quirk and
    `global_parent_sets` for the reproduced unmapped-first-block quirk."""
    gmi = None
    if not reduced_indices:
        gmi = merge_block_outputs(blockfile, outdir).gmi
    res: dict = {}
    for idx, bo in enumerate(_iter_blocks(blockfile, outdir)):
        for k, v in block_pheno_ancestor_sets(bo, depth).items():
            if gmi is not None and idx > 0:
                v = {int(gmi[ix]) for ix in v}
            res.setdefault(k, set()).update(v)
    return res


# ---------------------------------------------------------------------------
# PAG analysis (bdpc.py:683-745, 1637-1700, 2358-2387, 2583-2656)
# ---------------------------------------------------------------------------


def is_child(pag, v1, v2) -> bool:
    """v2 is a child of v1: v1 -> v2 (bdpc.py:710-711)."""
    return pag[v2, v1] == 2 and pag[v1, v2] == 3


def is_possible_child(pag, v1, v2) -> bool:
    """v1 -> v2 or v1 o-> v2 (bdpc.py:714-715)."""
    return pag[v2, v1] == 2 and (pag[v1, v2] == 3 or pag[v1, v2] == 1)


def pag_pheno_parent_sets(pag, num_phen: int, neighbor_fn, depth: int = 1
                          ) -> dict:
    """Markers within `depth` hops of each phenotype through
    `neighbor_fn`-qualified links, phenotype intermediates excluded
    (bdpc.py:683-707). Keys/values are 0-based PAG indices."""
    pag = np.asarray(pag.todense() if hasattr(pag, "todense") else pag)
    n = pag.shape[0]
    res = {}
    for p in range(num_phen):
        visited: set = set()
        frontier = {p}
        for _ in range(depth):
            nxt = set()
            for v1 in frontier:
                for v2 in np.nonzero(pag[v1])[0]:
                    v2 = int(v2)
                    if v2 >= num_phen and v2 not in visited and neighbor_fn(
                        pag, v1, v2
                    ):
                        nxt.add(v2)
                        visited.add(v2)
            frontier = nxt
        res[p] = visited
    return res


def pag_exclusive_pleiotropy_sets(
    pag_path: str, pheno_path: str, neighbor_fn=is_possible_child,
    depth: int = 1, pheno_codes: list[str] | None = None,
) -> dict:
    """Per-trait-pair shared parent markers from an estimated PAG
    (bdpc.py:718-739)."""
    p_names = (get_pheno_codes(pheno_path) if pheno_codes is None
               else pheno_codes)
    num_phen = len(p_names)
    pag = _load_mtx_dense(pag_path)
    pm = pag_pheno_parent_sets(pag, num_phen, neighbor_fn, depth)
    pleio: set = set()
    res = {}
    for i in range(num_phen):
        for j in range(i + 1, num_phen):
            s = pm[i] & pm[j]
            res[(i, j)] = s
            res[(j, i)] = s
            pleio.update(s)
    for i in range(num_phen):
        res[(i, i)] = pm[i] - pleio
    return res


def _pag_reach(pag: np.ndarray, num_phen: int, links: tuple) -> np.ndarray:
    """(num_phen, num_phen) 0/1 reachability over trait-trait edges whose
    endpoint pair is in `links`."""
    step = np.zeros((num_phen, num_phen), bool)
    sub = pag[:num_phen, :num_phen]
    for a, b in links:
        step |= (sub == a) & (sub.T == b)
    reach = np.zeros_like(step)
    for s in range(num_phen):
        visited = np.zeros(num_phen, bool)
        frontier = np.zeros(num_phen, bool)
        frontier[s] = True
        while frontier.any():
            nxt = step[frontier].any(axis=0) & ~visited
            visited |= nxt
            frontier = nxt
        reach[s] = visited
    return reach.astype(float)


def get_causal_paths(pag_path: str, pheno_path: str, pheno_names=None,
                     max_path_len=np.inf) -> np.ndarray:
    """Trait-trait definite-causal reachability over -> edges
    (bdpc.py:1665-1698). max_path_len bounds the hop count.

    Unlike the reference, max_path_len=inf terminates here (the
    reference's `while path_len < max_path_len` loop spins forever on
    empty queues, bdpc.py:1682-1696; reachability saturates within
    num_phen hops, so inf here equals the reference at any finite bound
    >= num_phen).
    """
    num_phen = len(pheno_names if pheno_names is not None
                   else get_pheno_codes(pheno_path))
    pag = _load_mtx_dense(pag_path)
    if np.isinf(max_path_len):
        return _pag_reach(pag, num_phen, ((2, 3),))
    sub = pag[:num_phen, :num_phen]
    step = (sub == 2) & (sub.T == 3)
    reach = np.zeros((num_phen, num_phen), bool)
    for s in range(num_phen):
        visited = np.zeros(num_phen, bool)
        frontier = np.zeros(num_phen, bool)
        frontier[s] = True
        hops = 0
        while hops < max_path_len and frontier.any():
            nxt = step[frontier].any(axis=0) & ~visited
            visited |= nxt
            frontier = nxt
            hops += 1
        reach[s] = visited
    return reach.astype(float)


def get_possibly_causal_paths(pag_path: str, pheno_path: str,
                              pheno_names=None) -> np.ndarray:
    """Reachability over -> and o-> trait edges (bdpc.py:1637-1663)."""
    num_phen = len(pheno_names if pheno_names is not None
                   else get_pheno_codes(pheno_path))
    pag = _load_mtx_dense(pag_path)
    return _pag_reach(pag, num_phen, ((2, 3), (2, 1)))


def pag_edge_types(pag_path: str, pheno_path: str) -> dict:
    """Tally of (mark_ij, mark_ji) endpoint pairs over all PAG links
    (bdpc.py:2358-2369)."""
    pag = _load_mtx_dense(pag_path)
    # enumerate nonzero pag[j, i] like the reference's lil-row walk (an
    # asymmetric half-edge must tally under the same key)
    out: dict = {}
    for j, i in zip(*np.nonzero(pag)):
        e = (int(pag[i, j]), int(pag[j, i]))
        out[e] = out.get(e, 0) + 1
    return out


def pag_x_to_y_edge_types(pag_path: str, pheno_path: str) -> dict:
    """Tally of marker->trait endpoint pairs (bdpc.py:2372-2386)."""
    num_phen = len(get_pheno_codes(pheno_path))
    pag = _load_mtx_dense(pag_path)
    out: dict = {}
    for j in range(num_phen):
        for i in np.nonzero(pag[j])[0]:
            if i >= num_phen:
                e = (int(pag[i, j]), int(pag[j, i]))
                out[e] = out.get(e, 0) + 1
    return out


def make_link_type_dict(adj: np.ndarray) -> dict:
    """Upper-triangle link classification of a weighted DAG adjacency
    (bdpc.py:2583-2594)."""
    n = adj.shape[0]
    out = {}
    for i in range(n):
        for j in range(i + 1, n):
            if adj[i, j] != 0 and adj[j, i] != 0:
                out[(i, j)] = (2, 2)
            elif adj[i, j] != 0:
                out[(i, j)] = (2, 3)
            elif adj[j, i] != 0:
                out[(i, j)] = (3, 2)
    return out


def make_adj_symmetric(adj: np.ndarray) -> np.ndarray:
    """Skeletonize a directed adjacency (bdpc.py:2597-2605)."""
    sym = (adj != 0) | (adj != 0).T
    np.fill_diagonal(sym, False)
    out = np.zeros_like(adj)
    out[sym] = 1
    return out


def pag_to_dag_directed(pag: np.ndarray) -> np.ndarray:
    """-> edges (and <-> as both) to a 0/1 DAG (bdpc.py:2608-2618)."""
    arrow_tail = (pag == 2) & (pag.T == 3)
    bidir = (pag == 2) & (pag.T == 2)
    return (arrow_tail | bidir).astype(pag.dtype)


def pag_to_dag_possibly_directed(pag: np.ndarray) -> np.ndarray:
    """-> and o-> edges (and <-> as both) to a 0/1 DAG
    (bdpc.py:2621-2633)."""
    poss = (pag == 2) & ((pag.T == 3) | (pag.T == 1))
    bidir = (pag == 2) & (pag.T == 2)
    return (poss | bidir).astype(pag.dtype)


def path_in_sem(adj: np.ndarray) -> np.ndarray:
    """Reachability matrix of a topologically-ordered SEM adjacency
    (bdpc.py:2636-2655; links assumed ordered toward larger indices)."""
    n = adj.shape[0]
    step = np.triu(adj != 0, k=1)
    reach = np.zeros((n, n), bool)
    for s in range(n - 1, -1, -1):
        direct = step[s]
        reach[s] = direct | reach[direct].any(axis=0)
    return reach


# ---------------------------------------------------------------------------
# marker-phenotype association tables (bdpc.py:2269-2355)
# ---------------------------------------------------------------------------


def _bim_columns(bim_path: str) -> tuple[list, list, list]:
    """(chr, rsID, bp) of every .bim row, typed as pandas reads them."""
    bim = read_columns(bim_path, "\t", list(range(6)))
    return bim[0].tolist(), bim[1].tolist(), bim[3].tolist()


def marker_pheno_associations(
    bim_path: str,
    corr_path: str,
    adj_path: str,
    ixs_path: str,
    num_phen: int | None = None,
    pheno_codes: list[str] | None = None,
    pheno_path: str | None = None,
) -> list[dict]:
    """Trait-adjacent markers with .bim annotation and the marker-trait
    correlation (bdpc.py:2307-2355), one dict per row with the keys
    phenotype, rsID, bim_line_ix, chr, bp, corr."""
    if num_phen is None and pheno_path is None:
        raise RuntimeError("Either num_phen or pheno_path have to specified")
    if pheno_codes is None and pheno_path is not None:
        pheno_codes = get_pheno_codes(pheno_path)
    if pheno_codes is None:
        p_names = list(range(1, num_phen + 1))
    else:
        p_names = pheno_codes
        num_phen = len(p_names)

    chrom, rsid, bp = _bim_columns(bim_path)
    adj = _load_mtx_dense(adj_path)
    corr = _load_mtx_dense(corr_path)
    glob_ixs = np.fromfile(ixs_path, dtype=np.int32)

    rows = []
    for pix in range(num_phen):
        hit = np.nonzero(adj[pix, num_phen:])[0]
        for m, c in zip(glob_ixs[hit].tolist(), corr[pix, num_phen:][hit].tolist()):
            rows.append({
                "phenotype": p_names[pix],
                "rsID": rsid[m],
                "bim_line_ix": m,
                "chr": chrom[m],
                "bp": bp[m],
                "corr": c,
            })
    return rows


def marker_pheno_associations_with_pnames(
    blockfile: str, outdir: str, p_names: list[str], bim_path: str,
    depth: int = 1,
) -> list[dict]:
    """Association table from per-block ancestor sets
    (bdpc.py:2269-2304), one dict per row with the keys phenotype, rsID,
    bim_line_ix, chr, bp."""
    chrom, rsid, bp = _bim_columns(bim_path)
    anc = global_ancestor_sets(blockfile, outdir, reduced_indices=False,
                               depth=depth)
    rows = []
    for pix in np.arange(len(p_names)) + BASE_INDEX:
        for bim_line in anc.get(pix, ()):  # bim row indices
            try:
                rows.append({
                    "phenotype": p_names[pix - BASE_INDEX],
                    "rsID": rsid[bim_line],
                    "bim_line_ix": bim_line,
                    "chr": chrom[bim_line],
                    "bp": bp[bim_line],
                })
            except IndexError:
                # out-of-range indices (e.g. the first block's unmapped
                # sparse indices) are skipped like the reference's
                # try/except (bdpc.py:2291-2302)
                print("pix: ", pix, "bim_line: ", bim_line)
    return rows


# ---------------------------------------------------------------------------
# plotting (bdpc.py:956-1360, 1362-1570 edge encodings, 1570-1635 plot_pag)
# ---------------------------------------------------------------------------


@dataclass
class EdgeEncoding:
    """PAG endpoint-pair display encoding (bdpc.py:1362-1366)."""

    str_rep: list
    int_rep: dict
    colors: list

    @property
    def cmap(self):
        import matplotlib as mpl

        return mpl.colors.ListedColormap(np.array(self.colors))


all_edge_types = EdgeEncoding(
    [r"$y_1 \; \; \; y_2$", r"$y_1$ o-o $y_2$", r"$y_1$ <-o $y_2$",
     r"$y_1$ o-> $y_2$", r"$y_1$ -o $y_2$", r"$y_1$ o- $y_2$",
     r"$y_1$ <-> $y_2$", r"$y_1$ -> $y_2$", r"$y_1$ <- $y_2$",
     r"$y_1$ - $y_2$"],
    {(0, 0): 0, (1, 1): 1, (1, 2): 2, (2, 1): 3, (1, 3): 4, (3, 1): 5,
     (2, 2): 6, (2, 3): 7, (3, 2): 8, (3, 3): 9},
    ["#ffffff", "#003f5c", "#2f4b7c", "#665191", "#a05195", "#d45087",
     "#f95d6a", "#ff7c43", "#ffa600", "#ffe300"],
)

simulation_edge_types = EdgeEncoding(
    [r"$y_1 \; \; \; y_2$", r"$y_1$ -> $y_2$", r"$y_1$ <- $y_2$",
     r"$y_1$ - $y_2$"],
    {(0, 0): 0, (2, 3): 1, (3, 2): 2, (3, 3): 3},
    ["#ffffff", "#fcc006", "#1f78b4", "#10a674"],
)

six_edge_types = EdgeEncoding(
    [r"$y_1 \; \; \; y_2$", r"$y_1$ <-> $y_2$", r"$y_1$ -> $y_2$",
     r"$y_1$ <- $y_2$", r"$y_1$ <-o $y_2$", r"$y_1$ o-> $y_2$",
     r"$y_1$ o-o $y_2$"],
    {(0, 0): 0, (2, 2): 1, (2, 3): 2, (3, 2): 3, (1, 2): 4, (2, 1): 5,
     (1, 1): 6},
    ["#ffffff", "#b2df8a", "#fcc006", "#1f78b4", "#510ac9", "#fd411e",
     "#d8dcd6"],
)


def heatmap(data, row_labels, col_labels, ax=None, cbar=True, cbar_kw=None,
            cbarlabel="", xlabel=None, ylabel=None, title=None,
            bad_color=None, title_kw=None, cbarlabel_rotation=0,
            rotation=45, grid=True, **kwargs):
    """Annotated heatmap helper (bdpc.py:956-1064)."""
    import matplotlib.pyplot as plt

    if ax is None:
        ax = plt.gca()
    cbar_kw = cbar_kw or {}
    if kwargs.get("cmap") is not None:
        cm = (plt.get_cmap(kwargs["cmap"])
              if isinstance(kwargs["cmap"], str) else kwargs["cmap"])
        cm.set_bad(bad_color or "white")
        kwargs["cmap"] = cm
    im = ax.imshow(data, **kwargs)
    cb = None
    if cbar:
        cb = ax.figure.colorbar(im, ax=ax, **cbar_kw)
        cb.ax.set_ylabel(cbarlabel, rotation=-90, va="bottom")
        if cbarlabel_rotation:
            plt.setp(cb.ax.get_yticklabels(), rotation=cbarlabel_rotation,
                     rotation_mode="anchor", ha="left")
    ax.set_xticks(np.arange(data.shape[1]), labels=col_labels)
    ax.set_yticks(np.arange(data.shape[0]), labels=row_labels)
    ax.tick_params(top=False, bottom=True, labeltop=False, labelbottom=True)
    plt.setp(ax.get_xticklabels(), rotation=rotation, ha="right",
             rotation_mode="anchor")
    ax.spines[:].set_visible(False)
    ax.set_xticks(np.arange(data.shape[1] + 1) - 0.5, minor=True)
    ax.set_yticks(np.arange(data.shape[0] + 1) - 0.5, minor=True)
    if grid:
        ax.grid(which="minor", color="#d8dcd6", linestyle="-", linewidth=1)
    ax.tick_params(which="minor", bottom=False, left=False)
    ax.set_ylabel(ylabel)
    ax.set_xlabel(xlabel)
    if title:
        ax.set_title(title, **(title_kw or {}))
    return im, cb


def get_skeleton_pleiotropy_mat(outdir: str, blockfile: str, pheno_path: str,
                                max_depth=np.inf, mat_type="exclusive",
                                num_phen: int | None = None) -> np.ndarray:
    """(num_phen, num_phen) pleiotropy-count matrix from the merged
    skeleton (bdpc.py:1067-1090)."""
    if num_phen is None:
        num_phen = len(get_pheno_codes(pheno_path))
    if mat_type == "exclusive":
        gm = global_epm(blockfile, outdir, max_depth=max_depth)
    elif mat_type == "union":
        gm = global_upm(blockfile, outdir, max_depth=max_depth)
    else:
        raise ValueError(f"Invalid mat_type: {mat_type}")
    z = np.zeros((num_phen, num_phen))
    for (i, j), c in gm.items():
        z[i - BASE_INDEX, j - BASE_INDEX] = c
    return z


def plot_skeleton_pleiotropy_mat_z(z, pheno_path=None, ax=None, title=None,
                                   cmap="BuPu", norm=None, cbar=True,
                                   cbarlabel=r"# shared ancestral markers",
                                   pheno_codes=None, **kwargs):
    """Lower-triangle pleiotropy heatmap (bdpc.py:1093-1133)."""
    p_names = pheno_codes if pheno_codes is not None else get_pheno_codes(
        pheno_path
    )
    mask = ~np.tri(z.shape[0], k=-1, dtype=bool)
    zm = np.ma.array(np.asarray(z, float), mask=mask)
    return heatmap(
        zm, p_names, p_names, cmap=cmap, norm=norm, cbar=cbar,
        cbar_kw={"fraction": 0.046, "pad": 0.04}, cbarlabel=cbarlabel,
        title=title, ax=ax, **kwargs,
    )[0]


def plot_skeleton_pleiotropy_mat(outdir: str, blockfile: str, pheno_path: str,
                                 max_depth=np.inf, **kwargs):
    """Pleiotropy heatmap straight from block outputs
    (bdpc.py:1136-1174)."""
    z = get_skeleton_pleiotropy_mat(outdir, blockfile, pheno_path,
                                    max_depth=max_depth)
    return plot_skeleton_pleiotropy_mat_z(z, pheno_path, **kwargs)


def plot_pleiotropy_mat(pag_path: str, pheno_path: str,
                        neighbor_fn=is_possible_child, depth: int = 1,
                        **kwargs):
    """PAG-based shared-parent heatmap (bdpc.py:1177-1219)."""
    sets = pag_exclusive_pleiotropy_sets(pag_path, pheno_path, neighbor_fn,
                                         depth)
    p_names = get_pheno_codes(pheno_path)
    num_phen = len(p_names)
    z = np.zeros((num_phen, num_phen))
    for i in range(num_phen):
        for j in range(i):
            z[i, j] = len(sets[(i, j)])
    return plot_skeleton_pleiotropy_mat_z(
        z, pheno_codes=p_names, cbarlabel=r"# shared parent markers",
        **kwargs,
    )


def load_ace(ace_path: str, pheno_path: str) -> np.ndarray:
    """Dense trait-trait ACE matrix (bdpc.py:1243-1251)."""
    num_phen = len(get_pheno_codes(pheno_path))
    return _load_mtx_dense(ace_path)[:num_phen, :num_phen]


def load_ace_directed_only(ace_path: str, pag_path: str,
                           pheno_path: str) -> np.ndarray:
    """ACE entries kept only where the PAG is definitely directed
    (bdpc.py:1221-1240)."""
    num_phen = len(get_pheno_codes(pheno_path))
    ace = _load_mtx_dense(ace_path)[:num_phen, :num_phen]
    pag = _load_mtx_dense(pag_path)[:num_phen, :num_phen]
    return np.where((pag == 2) & (pag.T == 3), ace, 0.0)


def plot_ace(ace_path: str, pheno_path: str, title=None, cmap="bwr",
             cbarlabel=r"$ACE \: (y_1 \rightarrow y_2)$", ax=None,
             norm=None, cbar=True, directed_only=False,
             pag_path: str | None = None, **kwargs):
    """Masked ACE heatmap (bdpc.py:1254-1359); directed_only keeps only
    definitely-directed PAG entries (needs pag_path)."""
    p_names = get_pheno_codes(pheno_path)
    z = (load_ace_directed_only(ace_path, pag_path, pheno_path)
         if directed_only else load_ace(ace_path, pheno_path))
    zm = np.ma.masked_array(z, z == 0.0)
    return heatmap(
        zm, p_names, p_names, cmap=cmap, cbarlabel=cbarlabel, cbar=cbar,
        xlabel=r"$y_2$", ylabel=r"$y_1$", title=title, ax=ax, norm=norm,
        **kwargs,
    )[0]


def plot_pag(pag_path: str, pheno_path: str, title=None,
             edge_encoding: EdgeEncoding = all_edge_types, ax=None,
             cbar=True, pheno_codes=None, pheno_subset=None,
             pheno_offset=0, pag=None):
    """Trait-trait PAG edge-type heatmap (bdpc.py:1570-1635)."""
    import matplotlib as mpl

    if pheno_codes is None:
        pheno_codes = get_pheno_codes(pheno_path)
    if pheno_subset is not None:
        pheno_indices = [pheno_codes.index(e) for e in pheno_subset]
        pheno_codes = pheno_subset
    else:
        pheno_indices = list(range(len(pheno_codes)))
    num_phen = len(pheno_indices)
    if pag is None:
        pag = _load_mtx_dense(pag_path)
    z = np.zeros((num_phen, num_phen))
    for i in range(num_phen):
        for j in range(i):
            a = pheno_offset + pheno_indices[i]
            b = pheno_offset + pheno_indices[j]
            z[i, j] = edge_encoding.int_rep[(int(pag[a, b]), int(pag[b, a]))]
    ne = len(edge_encoding.int_rep)
    norm = mpl.colors.BoundaryNorm(np.linspace(0, ne, ne + 1), ne)
    fmt = mpl.ticker.FuncFormatter(
        lambda x, pos: edge_encoding.str_rep[norm(x)]
    )
    im, _ = heatmap(
        z, pheno_codes, pheno_codes, cmap=edge_encoding.cmap, norm=norm,
        cbar=cbar, cbar_kw={"ticks": np.arange(ne) + 0.5, "format": fmt},
        xlabel=r"$y_2$", ylabel=r"$y_1$", title=title, ax=ax,
        cbarlabel_rotation=-50,
    )
    return im
