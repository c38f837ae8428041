"""Worker for the multi-process SHARDED-GRID test.

Launched as: python helpers_multiprocess_grid_worker.py <port> <pid>
<nproc> <out>

Two jax processes with 2 virtual CPU devices each form a 2x2
('rays', 'grid') mesh whose GRID axis spans the process boundary: the
device matrix is transposed so each mesh row (a ray shard's grid column)
contains one device from each process. Each process therefore holds only
half of every phi(k)-slab pair, and the sampler's corner psums cross
processes — the ">HBM snapshot" mode of SURVEY 5.8 exercised over a real
process boundary rather than a single-process virtual mesh.

The worker renders the mock simulation snapshot through
make_sharded_renderer and writes the (all-gathered) image for the driving
test to compare against a single-process replicated render.
"""

import os
import pathlib
import sys


def main():
    port, pid, nproc, out = sys.argv[1:5]
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["JAX_ENABLE_X64"] = "1"
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

    repo = pathlib.Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(repo))

    from blacklight.parallel import distributed

    distributed.initialize(coordinator_address=f"localhost:{port}",
                           num_processes=int(nproc), process_id=int(pid))
    assert jax.process_count() == int(nproc)

    import numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from blacklight import pipeline, read_config
    from blacklight.camera import make_camera
    from blacklight.parallel.grid_sharding import make_sharded_renderer
    from blacklight.pipeline_simulation import load_grid
    from blacklight.transfer.unpolarized import ImageOptions

    fixtures = repo / "tests/fixtures"
    cfg = read_config(str(fixtures / "golden_sim_rk4_32.input"))
    cfg.simulation_file = str(fixtures / "mock_small.athdf")
    cfg.camera_resolution = 8
    cfg.ray_max_steps = 600

    bh_m, bh_a, mass_msun = pipeline.bh_mass_spin(cfg)
    grid, snapshot_time = load_grid(cfg)
    geom, rays, freqs = make_camera(cfg, bh_m=bh_m, bh_a=bh_a)
    params = pipeline.geodesic_params_from_config(cfg, bh_m, bh_a)

    # Transposed device matrix: column g of each row is process g's
    # device — the 'grid' axis crosses the process boundary.
    devs = np.asarray(jax.devices()).reshape(int(nproc), 2).T
    mesh = Mesh(devs, ("rays", "grid"))
    assert len({d.process_index for d in devs[0]}) == int(nproc), \
        "grid axis must span processes"

    render = make_sharded_renderer(
        cfg, grid, geom, freqs, mesh, mass_msun, params,
        ImageOptions.from_config(cfg), snapshot_time=snapshot_time)

    # Globalize the ray bundle. With the transposed mesh each process owns
    # one device in EVERY ray shard (the grid axis is what crosses the
    # process boundary), so each process's local data spans the full ray
    # extent.
    def globalize(a):
        spec = P("rays") if a.ndim == 1 else P("rays", None)
        return jax.make_array_from_process_local_data(
            NamedSharding(mesh, spec), np.asarray(a))

    image = render(globalize(rays.positions), globalize(rays.directions),
                   globalize(rays.momentum_factors))

    np.savez(out, I_nu=image["I_nu"],
             process_count=jax.process_count())


if __name__ == "__main__":
    main()
