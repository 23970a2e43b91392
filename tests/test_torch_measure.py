"""The port's deck-measurement layer (pointcloud_bridge_tpu_torch/measure/)
against the JAX package's (pointcloud_bridge_tpu/measure/, numpy, scipy and
scikit-learn: no JAX compile) on the same synthetic decks, on the CPU:

- host stages bit for bit;
- PCA within 1e-10 with the same signs, both of scikit-learn's solvers;
- RANSAC: the inlier mask identical and the trial count equal;
- the isolation forest: scikit-learn's trees reproduced (same thresholds),
  so the mask is identical;
- LOF: the mask identical but for points whose negative outlier factor
  lies within 1e-6 relative of offset_ (the port picks neighbours in
  float32 through K5's plain version, scikit-learn's tree in float64: a
  near tie at the k-th neighbour may swap one neighbour);
- DBSCAN's noise mask identical;
- the chains within 0.5% in length and width, the relative error within
  0.005; wl_vision and grid_search as the JAX package's.
"""

import torch_cpu  # noqa: F401  (first: torch's threads a worker)

import os

import numpy as np
import pytest
import torch

from pointcloud_bridge_tpu.measure import wl_iden as J
from pointcloud_bridge_tpu.measure.optimize import grid_search as jax_grid_search
from pointcloud_bridge_tpu_torch.measure import wl_iden as P
from pointcloud_bridge_tpu_torch.measure.optimize import grid_search, parameter_grid
from pointcloud_bridge_tpu_torch.ops.grouping import knn_plain

DEV = "cpu"
# decks small enough for a test, tuned as the JAX package's test decks are
FAST_HP = dict(voxel_size=0.05, isolation_forest_contamination=0.1, lof_n_neighbors=20,
               lof_contamination=0.05)


def synthetic_deck(length=20.0, width=6.0, n=3000, angle=0.3, noise=0.01, outliers=0,
                   seed=0, z0=2.7, origin=(0.0, 0.0)):
    """tests/test_measure.py's deck: a dense rectangular slab rotated in
    plane, slight z noise, scattered outliers; ``origin`` shifts it (to
    georeferenced coordinates)."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, length, n)
    y = rng.uniform(0, width, n)
    z = z0 + rng.normal(0, noise, n)
    pts = np.stack([x, y, z], 1)
    c, s = np.cos(angle), np.sin(angle)
    rot = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
    pts = pts @ rot.T
    if outliers:
        out = np.stack([rng.uniform(-5, length + 5, outliers),
                        rng.uniform(-5, width + 5, outliers),
                        rng.uniform(0, 5, outliers)], 1)
        pts = np.concatenate([pts, out])
    return pts + np.array([origin[0], origin[1], 0.0])


DECKS = {
    "deck3k": dict(n=3000, outliers=300, seed=1),
    "deck4k_steep": dict(n=4000, outliers=800, seed=2, angle=1.1, noise=0.05),
    "deck2500_skew": dict(n=2500, outliers=500, seed=4, angle=-0.7),
}
# a deck at UTM-like coordinates: scikit-learn's PCA forms the uncentred
# Gram matrix there and loses the deck's variance to cancellation, so the
# port (centred first) is held to itself at the origin instead
GEOREF = (512_345.0, 4_180_321.0)


@pytest.fixture(params=sorted(DECKS))
def deck(request):
    return synthetic_deck(**DECKS[request.param])


# ------------------------------------------------------------ host stages


def test_host_stages_bit_for_bit(deck):
    xy = J.project_to_plane(deck)
    assert np.array_equal(P.project_to_plane(deck), xy)
    for pct in (20, 10):
        assert np.array_equal(P.detect_and_trim_edges(xy, pct), J.detect_and_trim_edges(xy, pct))
    rect = J.minimum_bounding_rectangle(xy)
    assert np.array_equal(P.minimum_bounding_rectangle(xy), rect)
    assert P.calculate_dimensions(xy, rect) == J.calculate_dimensions(xy, rect)
    assert np.array_equal(P.data_voxel(deck, 0.05), J.data_voxel(deck, 0.05))
    assert P.adaptive_voxel_size(deck) == J.adaptive_voxel_size(deck)
    assert np.array_equal(P.data_voxel(deck), J.data_voxel(deck))
    assert P.evaluate_result(20.0, 6.0, 19.5, 6.1) == J.evaluate_result(20.0, 6.0, 19.5, 6.1)


@pytest.mark.parametrize("q", [0.0, 2.5, 5.0, 10.0, 15.000000000000002, 30.000000000000004,
                               40.0, 50.0, 87.5, 99.9, 100.0])
def test_np_percentile_is_numpys(q):
    rng = np.random.default_rng(int(q * 10))
    for values in (rng.normal(size=1001), rng.normal(size=7), np.repeat(rng.normal(size=9), 5),
                   np.array([3.25])):
        assert P.np_percentile(torch.from_numpy(values), q) == np.percentile(values, q)


# -------------------------------------------------------------------- PCA


@pytest.mark.parametrize("n", [3000, 15])  # covariance_eigh, and the SVD below 10 d rows
def test_pca_matches_scikit_learn(n):
    from sklearn.decomposition import PCA

    pts = synthetic_deck(n=n, outliers=n // 10, seed=5)
    for d in (2, 3):
        x = pts[:, :d]
        sk = PCA(n_components=d)
        want = sk.fit_transform(x)
        got, fit = P.pca_fit_transform(torch.from_numpy(x), d)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-10)
        np.testing.assert_allclose(fit.components_.numpy(), sk.components_, rtol=0, atol=1e-12)
        assert np.array_equal(np.sign(fit.components_.numpy()), np.sign(sk.components_))
        np.testing.assert_allclose(fit.explained_variance_ratio_.numpy(),
                                   sk.explained_variance_ratio_, rtol=1e-12)
    want = J.align_to_principal_axes(pts[:, :2])
    got = P.align_to_principal_axes(pts[:, :2], DEV)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-10)
    assert np.array_equal(np.sign(got[np.abs(want) > 1e-9]), np.sign(want[np.abs(want) > 1e-9]))


def test_georeferenced_deck_measures_as_at_the_origin():
    local = synthetic_deck(n=2000, outliers=200, seed=3)
    far = local + np.array([GEOREF[0], GEOREF[1], 0.0])
    for length in (True, False):
        t_l, i_l, c_l, _ = P.directional_outlier_detection(local, 0.3, length, DEV)
        t_f, i_f, c_f, _ = P.directional_outlier_detection(far, 0.3, length, DEV)
        np.testing.assert_allclose(t_f, t_l, rtol=0, atol=1e-8)
        assert (i_f, c_f) == (i_l, c_l)
    np.testing.assert_allclose(P.align_to_principal_axes(far[:, :2], DEV),
                               P.align_to_principal_axes(local[:, :2], DEV), rtol=0, atol=1e-8)
    nof_l = P.lof_negative_outlier_factor(local, 30, DEV).numpy()
    nof_f = P.lof_negative_outlier_factor(far, 30, DEV).numpy()
    np.testing.assert_allclose(nof_f, nof_l, rtol=1e-6)
    # each stage on the same points (the voxel grid is not translation
    # invariant: floor(x / voxel) at 10^6 m rounds differently)
    assert np.array_equal(P.ransac_inlier_mask(far, 1000, 0.3, DEV)[0],
                          P.ransac_inlier_mask(local, 1000, 0.3, DEV)[0])
    shift = np.array([GEOREF[0], GEOREF[1], 0.0])
    for stage in (lambda p: P.isolation_forest_outlier_removal(p, 0.3, DEV),
                  lambda p: P.dbscan_outlier_removal(p, 0.05, 5, DEV)):
        np.testing.assert_allclose(stage(far) - shift, stage(local), rtol=0, atol=1e-6)
    got, want = P.process_raw(far, device=DEV), P.process_raw(local, device=DEV)
    _close(got[0], want[0], 1e-6)
    _close(got[1], want[1], 1e-6)


def test_directional_outlier_detection(deck):
    for length in (True, False):
        t_j, i_j, c_j, pca = J.directional_outlier_detection(deck, 0.3, length)
        t_p, i_p, c_p, fit = P.directional_outlier_detection(deck, 0.3, length, DEV)
        np.testing.assert_allclose(t_p, t_j, rtol=0, atol=1e-10)
        assert (i_p, c_p) == (i_j, c_j)


# ------------------------------------------------------------------ RANSAC


@pytest.mark.parametrize("n,outliers,threshold", [
    (3000, 300, 0.3),   # tracking selection, a few trials
    (200, 60, 0.3),     # below 300 points: a permutation a subset
    (2500, 2000, 0.1),  # 44% inliers: tens of trials, past the first chunk
])
def test_ransac_mask_and_trials_equal(n, outliers, threshold):
    from sklearn.linear_model import RANSACRegressor

    pts = synthetic_deck(n=n, outliers=outliers, seed=n)
    sk = RANSACRegressor(max_trials=1000, residual_threshold=threshold,
                         random_state=42).fit(pts[:, :2], pts[:, 2])
    mask, trials = P.ransac_inlier_mask(pts, 1000, threshold, DEV)
    print(f"RANSAC n={len(pts)}: {trials} trials, {mask.sum()} inliers")
    assert trials == sk.n_trials_
    assert np.array_equal(mask, sk.inlier_mask_)
    assert np.array_equal(P.ransac_plane_fit(pts, 1000, threshold, DEV),
                          J.ransac_plane_fit(pts, 1000, threshold))


def test_ransac_subsets_are_scikit_learns():
    from sklearn.utils.random import sample_without_replacement

    for n, k in ((5000, 3), (299, 3), (300, 3), (4, 3), (3, 3), (25_600, 256), (1000, 256),
                 (257, 256), (256, 256), (1, 1)):
        ours, theirs = np.random.RandomState(42), np.random.RandomState(42)
        for _ in range(20):
            assert np.array_equal(P.sample_without_replacement(n, k, ours),
                                  sample_without_replacement(n, k, random_state=theirs))


def test_plane_models_are_least_squares():
    rng = np.random.default_rng(0)
    xs = rng.normal(size=(50, 3, 2))
    zs = rng.normal(size=(50, 3))
    xs[0, 2] = xs[0, 0]                         # two equal points: still a plane
    xs[1] = np.array([[0.0, 0.0], [1.0, 2.0], [2.0, 4.0]])  # collinear
    xs[2] = 1.5                                 # one site
    got = P._plane_models(torch.from_numpy(xs), torch.from_numpy(zs)).numpy()
    for t in range(50):
        a = np.concatenate([xs[t] - xs[t].mean(0)], 1)
        coef = np.linalg.lstsq(a, zs[t] - zs[t].mean(), rcond=3 * np.finfo(float).eps)[0]
        np.testing.assert_allclose(got[t, :2], coef, rtol=1e-8, atol=1e-10)
        np.testing.assert_allclose(got[t, 2], zs[t].mean() - xs[t].mean(0) @ coef, atol=1e-10)


# -------------------------------------------------------- isolation forest


def test_isolation_trees_are_scikit_learns(deck):
    from sklearn.ensemble import IsolationForest

    t, i, c, _ = J.directional_outlier_detection(deck, 0.3, True)
    feature = t[:, i]
    sk = IsolationForest(contamination=c, random_state=42).fit(feature[:, None])
    trees, max_samples = P.isolation_forest_trees(feature)
    assert max_samples == sk.max_samples_ and len(trees) == len(sk.estimators_)
    for est, tree in zip(sk.estimators_, trees):
        split = est.tree_.children_left != -1
        assert np.array_equal(np.sort(est.tree_.threshold[split]), np.sort(tree.threshold[tree.left >= 0]))
        assert np.array_equal(np.sort(est.tree_.n_node_samples), np.sort(tree.count))
    assert np.array_equal(P.isolation_forest_inliers(feature, c, DEV),
                          sk.predict(feature[:, None]) == 1)


def test_isolation_forest_outlier_removal_identical(deck):
    assert np.array_equal(P.isolation_forest_outlier_removal(deck, 0.3, DEV),
                          J.isolation_forest_outlier_removal(deck, 0.3))


# ------------------------------------------------------------ neighbours


def test_knn_picks_on_the_cpu_are_knn_plains(monkeypatch):
    rng = np.random.default_rng(0)
    monkeypatch.setattr(P, "_CHUNK_PAIRS", 3000)  # many chunks
    for pts, k in ((rng.normal(size=(700, 3)), 31), (rng.integers(0, 4, (600, 3)), 21),
                   (rng.integers(0, 3, (300, 3)), 5), (rng.normal(size=(40, 3)), 35)):
        x = torch.from_numpy(pts.astype(np.float32))
        d2, idx = P.knn_picks(x, x, k)
        want_d2, want_idx = knn_plain(x[None], x[None], k)
        assert torch.equal(d2, want_d2[0]) and torch.equal(idx, want_idx[0].long())
        q = x[::7].contiguous()
        d2, idx = P.knn_picks(x, q, 1)
        want_d2, want_idx = knn_plain(x[None], q[None], 1)
        assert torch.equal(d2, want_d2[0]) and torch.equal(idx, want_idx[0].long())


def test_drop_self_with_duplicates():
    idx = torch.tensor([[0, 1, 2], [0, 1, 2], [0, 1, 3], [5, 6, 7]])
    got = P._drop_self(idx)
    assert got.tolist() == [[1, 2], [0, 2], [1, 3], [6, 7]]


def test_lof_mask_identical_off_the_threshold(deck):
    from sklearn.neighbors import LocalOutlierFactor

    for n_neighbors, contamination in ((30, 0.4), (20, 0.05), (50, 0.1)):
        sk = LocalOutlierFactor(n_neighbors=n_neighbors, contamination=contamination).fit(deck)
        nof = P.lof_negative_outlier_factor(deck, n_neighbors, DEV).numpy()
        offset = P.np_percentile(torch.from_numpy(nof), 100.0 * contamination)
        near = np.abs(sk.negative_outlier_factor_ - sk.offset_) <= 1e-6 * abs(sk.offset_)
        ours, theirs = nof >= offset, sk.negative_outlier_factor_ >= sk.offset_
        print(f"LOF k={n_neighbors}: {near.sum()} points within 1e-6 of offset_, "
              f"{(ours != theirs).sum()} differ, max |nof diff| "
              f"{np.abs(nof - sk.negative_outlier_factor_).max():.3g}")
        assert np.array_equal(ours[~near], theirs[~near])
        np.testing.assert_allclose(offset, sk.offset_, rtol=1e-6)
    got = P.lof_outlier_removal(deck, 30, 0.4, DEV)
    want = J.lof_outlier_removal(deck, 30, 0.4)
    assert abs(len(got) - len(want)) <= 2


def test_adaptive_lof_params_equal(deck):
    assert P.adaptive_lof_params(deck, device=DEV) == J.adaptive_lof_params(deck)
    got = P.lof_outlier_removal(deck, device=DEV)
    want = J.lof_outlier_removal(deck)
    assert abs(len(got) - len(want)) <= 2


def test_dbscan_noise_mask_identical(deck):
    for eps, min_samples in ((1.0, 5), (0.05, 5), (0.08, 12), (0.02, 1)):
        assert np.array_equal(P.dbscan_outlier_removal(deck, eps, min_samples, DEV),
                              J.dbscan_outlier_removal(deck, eps, min_samples))
    few = deck[:3]
    assert np.array_equal(P.dbscan_outlier_removal(few, 1.0, 5, DEV),
                          J.dbscan_outlier_removal(few, 1.0, 5))


def test_the_kernel_path_refuses_more_than_64_neighbours():
    meta = torch.zeros(100, 3, device="meta")
    with pytest.raises(ValueError, match="k <= 64"):
        P.knn_picks(meta, meta, 65)
    with pytest.raises(ValueError, match="k <= 64"):
        P.lof_negative_outlier_factor(synthetic_deck(n=200), 64, torch.device("meta"))


def test_no_card_is_an_error():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        P.process_raw(synthetic_deck(n=500))


# ----------------------------------------------------------------- chains


def _close(got, want, rel=0.005):
    assert abs(got - want) <= rel * abs(want), (got, want)


def test_process_bridge_deck_and_raw(deck):
    got = P.process_bridge_deck(deck, device=DEV, **FAST_HP)
    want = J.process_bridge_deck(deck, **FAST_HP)
    _close(got[0], want[0])
    _close(got[1], want[1])
    got = P.process_raw(deck, device=DEV)
    want = J.process_raw(deck)
    _close(got[0], want[0])
    _close(got[1], want[1])


def test_process_bridge_deck_at_the_defaults():
    deck = synthetic_deck(n=4000, outliers=400, seed=7)
    got = P.process_bridge_deck(deck, device=DEV)
    want = J.process_bridge_deck(deck)
    _close(got[0], want[0])
    _close(got[1], want[1])
    assert np.array_equal(got[3], want[3])


def test_run_wl_identification(tmp_path):
    raw = synthetic_deck(n=4000, seed=2)
    pred = synthetic_deck(n=3000, outliers=200, seed=3)
    got = P.run_wl_identification([("b1", raw, pred)], out_csv=str(tmp_path / "eval.csv"),
                                  hyperparams=FAST_HP, fig_dir=str(tmp_path), device=DEV)
    want = J.run_wl_identification([("b1", raw, pred)], hyperparams=FAST_HP)
    for key in ("length_raw", "width_raw", "length_pred", "width_pred"):
        _close(got[0][key], want[0][key])
    assert abs(got[0]["relative_error"] - want[0]["relative_error"]) <= 0.005
    assert (tmp_path / "eval.csv").exists() and (tmp_path / "b1_overlay.png").exists()


def test_wl_vision(tmp_path):
    from pointcloud_bridge_tpu_torch.data.lasio import write_las
    from pointcloud_bridge_tpu_torch.measure.wl_vision import (
        main as vision_main,
        process_bridge_deck_visualized,
    )

    pred = synthetic_deck(n=3000, outliers=200, seed=6)
    l_ref, w_ref, _, rect_ref = P.process_bridge_deck(pred, device=DEV, **FAST_HP)
    l_v, w_v, _, rect_v, figs = process_bridge_deck_visualized(
        pred, str(tmp_path / "steps"), device=DEV, **FAST_HP)
    assert (l_v, w_v) == (l_ref, w_ref)
    np.testing.assert_array_equal(rect_v, rect_ref)
    assert len(figs) == 7 and all(os.path.getsize(f) > 0 for f in figs)

    raw = synthetic_deck(n=3000, seed=7)
    raw_las, pred_las = str(tmp_path / "raw.las"), str(tmp_path / "pred.las")
    write_las(raw_las, raw, None, np.full(len(raw), 3, np.int32))
    write_las(pred_las, pred, None, np.full(len(pred), 3, np.int32))
    res = vision_main([raw_las, pred_las, "--label", "3", "--out", str(tmp_path / "cli"),
                       "--voxel", "0.05", "--device", "cpu"])
    assert len(list((tmp_path / "cli").glob("*.png"))) == 7
    from pointcloud_bridge_tpu_torch.data.lasio import read_las

    raw_deck, pred_deck = read_las(raw_las).xyz, read_las(pred_las).xyz
    want = J.process_raw(raw_deck) + J.process_bridge_deck(pred_deck, voxel_size=0.05)
    for key, at in (("length_raw", 0), ("width_raw", 1), ("length_pred", 4), ("width_pred", 5)):
        _close(res[key], want[at])


def test_grid_search_ranks_as_the_jax_package():
    raw = synthetic_deck(n=3000, seed=2)
    pred = synthetic_deck(n=3000, outliers=200, seed=3)
    grid = {"voxel_size": [0.05], "percentile": [10, 20, 30],
            "isolation_forest_contamination": [0.1], "lof_contamination": [0.05],
            "lof_n_neighbors": [20]}
    assert parameter_grid(grid) == [dict(zip(sorted(grid), c)) for c in
                                    [(0.1, 0.05, 20, 10, 0.05), (0.1, 0.05, 20, 20, 0.05),
                                     (0.1, 0.05, 20, 30, 0.05)]]
    got = grid_search([("b1", raw, pred)], grid, device=DEV)
    want = jax_grid_search([("b1", raw, pred)], grid)
    assert [r["params"] for r in got] == [r["params"] for r in want]
    for g, w in zip(got, want):
        assert abs(g["mean_error"] - w["mean_error"]) <= 0.005
