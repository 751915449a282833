"""PyTorch port: the plots take tensors (copied to the host) and draw what
the JAX package's plots draw; ``cost_to_color_ids`` equals the JAX one on
the same costs. The plots write their files under matplotlib's Agg
backend."""

import matplotlib

matplotlib.use("Agg")

import numpy as np
import pytest
import torch

from husky_rover_mppi_isaacsim_torch.aux import visualize as tviz
from husky_rover_mppi_isaacsim_tpu.aux import visualize as jviz

torch.set_num_threads(1)


@pytest.mark.parametrize("num_colors", [256, 17])
def test_cost_to_color_ids_matches_jax(num_colors):
    costs = np.random.default_rng(0).gamma(2.0, 30.0, 500)
    costs[3] = 1e5  # a colliding sample
    got = tviz.cost_to_color_ids(torch.from_numpy(costs), num_colors)
    want = jviz.cost_to_color_ids(costs, num_colors)
    assert np.array_equal(got, want)
    assert got.min() == 0 and got.max() == num_colors - 1
    assert np.array_equal(tviz.cost_to_color_ids(costs.astype(np.float32)),
                          jviz.cost_to_color_ids(costs.astype(np.float32)))


def _scene(hw=10.0, n=64):
    rng = np.random.default_rng(1)
    z = torch.from_numpy(rng.normal(size=(n, n)))
    cost = torch.from_numpy(rng.uniform(0, 1, (n // 2, n // 2)))
    t = torch.linspace(0, 1, 30, dtype=torch.float64)
    rollouts = torch.stack([torch.stack([t * 8 - 4, t * k / 10, t], -1) for k in range(50)])
    return hw, z, cost, rollouts


def test_plots_write_files(tmp_path):
    hw, z, cost, rollouts = _scene()
    paths = [tmp_path / "spread.png", tmp_path / "frames" / "costmap_0000.png",
             tmp_path / "run.png"]
    tviz.plot_rollout_spread(z, hw, cost, rollouts, optimal=rollouts[0],
                             goal=torch.tensor([4.0, 3.0]), save_path=paths[0], stride=10)
    tviz.plot_costmap(cost, hw, save_path=str(paths[1]))
    tviz.plot_closed_loop_run(rollouts[3, :, :2], (4.0, 3.0), z=z, half_width=hw,
                              save_path=paths[2])
    for p in paths:
        assert p.is_file() and p.stat().st_size > 1000 and p.read_bytes()[:4] == b"\x89PNG"


def test_plots_draw_what_jax_draws():
    """The same scene through both packages' plots: the same images and
    lines, axis by axis."""
    import matplotlib.pyplot as plt

    hw, z, cost, rollouts = _scene()
    figs = [
        (tviz.plot_rollout_spread(z, hw, cost, rollouts, optimal=rollouts[0], goal=(4.0, 3.0)),
         jviz.plot_rollout_spread(z.numpy(), hw, cost.numpy(), rollouts.numpy(),
                                  optimal=rollouts[0].numpy(), goal=(4.0, 3.0))),
        (tviz.plot_closed_loop_run(rollouts[3, :, :2], (4.0, 3.0), z=z, half_width=hw),
         jviz.plot_closed_loop_run(rollouts[3, :, :2].numpy(), (4.0, 3.0), z=z.numpy(),
                                   half_width=hw)),
    ]
    for got, want in figs:
        ga, wa = got.axes[0], want.axes[0]
        assert len(ga.images) == len(wa.images) and len(ga.lines) == len(wa.lines) > 0
        for a, b in zip(ga.images, wa.images):
            assert np.array_equal(np.ma.getdata(a.get_array()), np.ma.getdata(b.get_array()))
        for a, b in zip(ga.lines, wa.lines):
            assert np.array_equal(a.get_xydata(), b.get_xydata())
        assert ga.get_title() == wa.get_title()
        plt.close(got)
        plt.close(want)
