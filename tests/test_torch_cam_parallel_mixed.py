"""The camera axis (``parallel/mesh.py``) under the two mixed pairs of
nets, on the CPU: gloo ranks of the (data 2, cam 2) grid on the 6-camera
rig, as ``tests/test_torch_cam_parallel_fsm_aug.py`` runs the fsm nets,
against the JAX package's unsharded step over the global batch and the
port's own single-process step, with
``tests/test_torch_cam_parallel_options.py``'s checks and bounds.

* a fusion depth net with the fsm pose net (``pose_loss_coeff`` 0.1): the
  depth net's own back-projection summed over the cam group, the pose
  net's per-camera poses gathered over it (site "cam_poses");
* the fsm depth net (at 64x96) with the fusion pose net: the pose net's
  own back-projection summed over the cam group.

The batch's rig is yawed by 0.1 rad (``helpers_torch_cam_options.YAW``).
"""
import pytest

import helpers_torch_cam_options as H
from helpers_torch_threads import port_threads  # noqa: F401
from test_torch_cam_parallel_options import (
    SHARED, check_against_single, check_auto_masks,
    check_batchnorm_against_jax, check_collectives,
    check_gradients_against_jax, check_logs_against_jax,
    check_ranks_bit_identical, prepare_grid)

GRID = "2x2_mixed"
OPTIONS = H.grid_options(GRID)
JAX_HELD = [o for o in OPTIONS if o not in SHARED]


@pytest.fixture(scope="module")
def grid(tmp_path_factory):
    return prepare_grid(GRID, tmp_path_factory.mktemp(f"cam_opt_{GRID}"))


@pytest.mark.parametrize("option", OPTIONS)
def test_collectives_by_site(grid, option):
    check_collectives(grid[option], option)


@pytest.mark.parametrize("option", OPTIONS)
def test_auto_masks_agree(grid, option):
    check_auto_masks(grid[option])


@pytest.mark.parametrize("option", OPTIONS)
def test_ranks_bit_identical(grid, option):
    check_ranks_bit_identical(grid[option])


@pytest.mark.parametrize("option", OPTIONS)
def test_step_against_single_process(grid, option):
    check_against_single(grid[option])


@pytest.mark.parametrize("option", JAX_HELD)
def test_step_logs_against_jax(grid, option):
    check_logs_against_jax(grid[option])


@pytest.mark.parametrize("net", ["depth_net", "pose_net"])
@pytest.mark.parametrize("option", JAX_HELD)
def test_step_gradients_against_jax(grid, option, net):
    check_gradients_against_jax(grid[option], net)


@pytest.mark.parametrize("net", ["depth_net", "pose_net"])
@pytest.mark.parametrize("option", JAX_HELD)
def test_step_batchnorm_against_jax(grid, option, net):
    check_batchnorm_against_jax(grid[option], net)
