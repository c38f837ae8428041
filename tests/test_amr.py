"""Exact cross-level AMR interblock sampling tests.

The fixture mock_amr.athdf is a genuine mixed-refinement Athena++ snapshot
(2x2x2 root blocks with two of them replaced by their 8 level-1 children,
written by scripts/generate_mock_simulation.py write_athena_amr). The
golden npz is the reference binary's output with
simulation_block_interp = true - the configuration that exercises
FindNearbyInds' same/coarser/finer neighbor resolution, phi periodicity,
and constant extrapolation (simulation_sampling.cpp:1068-1321).
"""

import numpy as np
import pytest

from blacklight import read_config
from blacklight.pipeline_simulation import render_simulation_image


@pytest.fixture(scope="module")
def amr_grid(fixtures_dir):
    import jax.numpy as jnp  # noqa: F401 (ensures jax configured)

    from blacklight.grid.amr import with_amr_table
    from blacklight.grid.athena import load_athdf, with_packed_corners

    g = load_athdf(str(fixtures_dir / "mock_amr.athdf"))
    return with_packed_corners(with_amr_table(g))


def test_amr_metadata_loaded(amr_grid):
    g = amr_grid
    assert g.levels is not None and g.locations is not None
    assert int(g.levels.max()) == 1
    assert g.n3_root == 8
    assert g.amr_table is not None
    assert g.amr_table.shape == (g.n_blocks, 27, 8, 5)


def test_amr_golden_parity(fixtures_dir):
    """End-to-end I_nu matches the reference binary exactly on the
    mixed-level grid with interblock interpolation enabled."""
    cfg = read_config(str(fixtures_dir / "golden_amr_rk4_32.input"))
    cfg.simulation_file = str(fixtures_dir / "mock_amr.athdf")
    image, rays, freqs, mass = render_simulation_image(cfg)
    gold = np.load(fixtures_dir / "golden_amr_rk4_32.npz")
    ours = np.asarray(image["I_nu"][:, 0]).reshape(32, 32)
    g = gold["I_nu"]
    assert np.array_equal(np.isnan(ours), np.isnan(g))
    scale = np.nanmax(np.abs(g))
    rel = np.abs(ours - g) / (np.abs(g) + scale * 1e-8)
    assert np.nanmax(rel) < 1e-8, f"max rel {np.nanmax(rel)}"


def test_amr_sampler_matches_host_transcription(amr_grid):
    """The device table-driven sampler reproduces a direct per-sample host
    transcription of the reference algorithm at thousands of random
    points (cross-checks every FindNearbyInds case batched logic)."""
    import jax.numpy as jnp

    from blacklight.grid.sampling import SamplerOptions, sample_grid
    from helpers_amr_host import sample_point

    g = amr_grid
    grid_np = dict(
        x1f=np.asarray(g.x1f), x2f=np.asarray(g.x2f), x3f=np.asarray(g.x3f),
        x1v=np.asarray(g.x1v), x2v=np.asarray(g.x2v), x3v=np.asarray(g.x3v),
        prim=np.asarray(g.prim), levels=[int(x) for x in g.levels],
        locs=[tuple(int(v) for v in row) for row in g.locations])

    rng = np.random.default_rng(3)
    n = 1500
    r = np.exp(rng.uniform(np.log(2.0), np.log(50.0), n))
    th = rng.uniform(0.05, np.pi - 0.05, n)
    ph = rng.uniform(0.0, 2 * np.pi, n)
    x = r * np.sin(th) * np.cos(ph)
    y = r * np.sin(th) * np.sin(ph)
    z = r * np.cos(th)
    pos = np.stack([np.zeros(n), x, y, z], -1)
    opts = SamplerOptions(interp=True, block_interp=True, fallback_nan=True)
    out = sample_grid(g, jnp.asarray(pos), 0.0, opts)
    rho_dev = np.asarray(out["rho"])
    off = np.asarray(out["off_grid"])

    ind_rho = g.ind["rho"]
    checked = 0
    for s in range(n):
        res = sample_point(grid_np, r[s], th[s], ph[s], True, g.n3_root)
        if res is None:
            assert off[s]
            continue
        vals, info = res
        checked += 1
        hv = np.float64(np.float32(vals[ind_rho]))
        assert np.isclose(hv, rho_dev[s], rtol=1e-6, atol=1e-30), \
            (s, hv, rho_dev[s], info)
    assert checked > n // 2


def test_amr_cks_grid_matches_host_transcription():
    """The neighbor-table machinery also covers CKS (AthenaK-style) grids:
    no phi periodicity, containment by Cartesian face bounds. Checked
    against the host transcription on a synthetic two-level block layout
    built in memory."""
    import jax.numpy as jnp

    from blacklight.grid.amr import with_amr_table
    from blacklight.grid.athena import SimulationGrid
    from blacklight.grid.sampling import SamplerOptions, sample_grid
    from helpers_amr_host import sample_point

    rng = np.random.default_rng(11)
    nb_cells = 8
    # Root domain [-1,1]^3 as 2x2x2 blocks of 8^3 cells; refine block
    # (0,0,0) into its 8 children.
    blocks = []
    for lk in range(2):
        for lj in range(2):
            for li in range(2):
                if (li, lj, lk) == (0, 0, 0):
                    continue
                blocks.append((0, li, lj, lk))
    for ck in range(2):
        for cj in range(2):
            for ci in range(2):
                blocks.append((1, ci, cj, ck))
    n_b = len(blocks)
    x1f = np.zeros((n_b, nb_cells + 1))
    x2f = np.zeros((n_b, nb_cells + 1))
    x3f = np.zeros((n_b, nb_cells + 1))
    prim = rng.random((8, n_b, nb_cells, nb_cells, nb_cells)).astype(
        np.float32)
    levels = np.zeros(n_b, np.int32)
    locs = np.zeros((n_b, 3), np.int64)
    for bi, (lev, li, lj, lk) in enumerate(blocks):
        size = 1.0 / (1 << lev)          # block half-width fraction
        for arr, loc in ((x1f, li), (x2f, lj), (x3f, lk)):
            lo = -1.0 + 2.0 * size * loc
            arr[bi] = np.linspace(lo, lo + 2.0 * size, nb_cells + 1)
        levels[bi] = lev
        locs[bi] = (li, lj, lk)

    def centers(f):
        return 0.5 * (f[:, :-1] + f[:, 1:])

    grid = SimulationGrid(
        prim=jnp.asarray(prim),
        x1f=jnp.asarray(x1f), x1v=jnp.asarray(centers(x1f)),
        x2f=jnp.asarray(x2f), x2v=jnp.asarray(centers(x2f)),
        x3f=jnp.asarray(x3f), x3v=jnp.asarray(centers(x3f)),
        ind={"rho": 0, "pgas": 1, "uu1": 2, "uu2": 3, "uu3": 4,
             "bb1": 5, "bb2": 6, "bb3": 7},
        time=0.0, coords="cks", levels=levels, locations=locs, n3_root=16)
    grid = with_amr_table(grid)
    assert grid.amr_table is not None

    n = 800
    pts = rng.uniform(-0.99, 0.99, (n, 3))
    pos = np.concatenate([np.zeros((n, 1)), pts], axis=1)
    opts = SamplerOptions(interp=True, block_interp=True, fallback_nan=True)
    out = sample_grid(grid, jnp.asarray(pos), 0.0, opts)
    rho_dev = np.asarray(out["rho"])

    grid_np = dict(
        x1f=x1f, x2f=x2f, x3f=x3f,
        x1v=centers(x1f), x2v=centers(x2f), x3v=centers(x3f),
        prim=prim.astype(np.float64),
        levels=[int(v) for v in levels],
        locs=[tuple(int(v) for v in row) for row in locs])
    checked = 0
    for s in range(n):
        res = sample_point(grid_np, pts[s, 0], pts[s, 1], pts[s, 2],
                           False, grid.n3_root)
        if res is None:
            assert out["off_grid"][s]
            continue
        vals, info = res
        checked += 1
        hv = np.float64(np.float32(vals[0]))
        assert np.isclose(hv, rho_dev[s], rtol=1e-6), (s, hv, rho_dev[s],
                                                       info)
    assert checked > n // 2
