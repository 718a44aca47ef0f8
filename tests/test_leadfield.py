"""Spherical-head EEG forward model (`ops/leadfield.py`): independent
z-axis associated-Legendre oracle, the center-dipole closed form,
harmonic zero-mean and rotation-equivariance identities, series
convergence, and end-to-end LCMV localization through our own
beamformer."""
import numpy as np
import pytest

from ninwavelets_tpu.ops.leadfield import (fibonacci_electrodes,
                                           source_grid, sphere_leadfield)

R = 0.09
SIGMA = 0.33


def _oracle_zaxis(theta, phi, b, q, n_terms=300):
    """Independent float64 series for a dipole at (0, 0, b): textbook
    associated-Legendre form with explicit gamma/phi geometry —
    a genuinely different code path from the production kernel.

    V = 1/(4 pi sigma R^2) sum_n (2n+1)/n f^{n-1}
        [ n q_z P_n(cos th) + (qx cos phi + qy sin phi) A_n(cos th) ]
    with A_n = sin th * P_n'(cos th).
    """
    from numpy.polynomial import legendre as L
    f = b / R
    v = np.zeros_like(theta)
    ct, st = np.cos(theta), np.sin(theta)
    n = np.arange(1, n_terms + 1, dtype=np.float64)
    w = (2 * n + 1) / n * f ** (n - 1)
    for i, (t, p) in enumerate(zip(ct, phi)):
        rad = tan = 0.0
        for k in range(1, n_terms + 1):
            coef = np.zeros(k + 1)
            coef[k] = 1.0
            rad += w[k - 1] * k * L.legval(t, coef)
            tan += w[k - 1] * L.legval(t, L.legder(coef))
        v[i] = (q[2] * rad
                + (q[0] * np.cos(p) + q[1] * np.sin(p)) * st[i] * tan)
    return v / (4 * np.pi * SIGMA * R * R)


class TestOracle:
    def test_matches_independent_series(self):
        rng = np.random.default_rng(0)
        theta = rng.uniform(0.1, np.pi - 0.1, 12)
        phi = rng.uniform(0, 2 * np.pi, 12)
        elec = R * np.stack([np.sin(theta) * np.cos(phi),
                             np.sin(theta) * np.sin(phi),
                             np.cos(theta)], 1)
        for b in (0.02, 0.05, 0.075):
            for q in (np.array([0.0, 0.0, 1.0]),
                      np.array([1.0, 0.0, 0.0]),
                      np.array([0.3, -0.5, 0.8])):
                want = _oracle_zaxis(theta, phi, b, q)
                lf = sphere_leadfield(elec, np.array([[0, 0, b]]),
                                      radius=R, sigma=SIGMA)
                got = np.asarray(lf)[:, 0, :] @ q
                np.testing.assert_allclose(got, want, rtol=5e-4,
                                           atol=1e-9 * np.abs(want).max())

    def test_center_dipole_closed_form(self):
        elec = fibonacci_electrodes(60, R, upper_only=False)
        q = np.array([0.2, -0.7, 0.4])
        lf = sphere_leadfield(elec, np.zeros((1, 3)), radius=R,
                              sigma=SIGMA)
        got = np.asarray(lf)[:, 0, :] @ q
        want = 3.0 * (elec / R) @ q / (4 * np.pi * SIGMA * R * R)
        np.testing.assert_allclose(got, want, rtol=1e-5)


class TestIdentities:
    def test_zero_mean_on_uniform_layout(self):
        """Every n>=1 spherical harmonic integrates to zero: a dense
        uniform layout's mean potential must vanish relative to its
        spread."""
        elec = fibonacci_electrodes(800, R, upper_only=False)
        src = np.array([[0.02, -0.01, 0.04], [0.0, 0.05, 0.02]])
        lf = np.asarray(sphere_leadfield(elec, src, radius=R))
        for s in range(2):
            for k in range(3):
                v = lf[:, s, k]
                assert abs(v.mean()) < 2e-3 * np.abs(v).max()

    def test_rotation_equivariance(self):
        rng = np.random.default_rng(1)
        # random rotation matrix
        a = rng.standard_normal((3, 3))
        qmat, _ = np.linalg.qr(a)
        if np.linalg.det(qmat) < 0:
            qmat[:, 0] *= -1
        elec = fibonacci_electrodes(40, R)
        src = np.array([[0.01, 0.02, 0.05]])
        lf = np.asarray(sphere_leadfield(elec, src, radius=R))
        lf_rot = np.asarray(sphere_leadfield(elec @ qmat.T,
                                             src @ qmat.T, radius=R))
        # rotating everything rotates the orientation axis the same way
        np.testing.assert_allclose(lf_rot, lf @ qmat.T, rtol=2e-3,
                                   atol=1e-9 * np.abs(lf).max())

    def test_series_convergence(self):
        elec = fibonacci_electrodes(30, R)
        src = np.array([[0.0, 0.0, 0.07]])      # eccentricity 0.78
        a = np.asarray(sphere_leadfield(elec, src, radius=R,
                                        n_terms=120))
        b = np.asarray(sphere_leadfield(elec, src, radius=R,
                                        n_terms=240))
        np.testing.assert_allclose(a, b, rtol=1e-4,
                                   atol=1e-6 * np.abs(b).max())


class TestValidationAndHelpers:
    def test_eccentricity_and_shape_guards(self):
        elec = fibonacci_electrodes(10, R)
        with pytest.raises(ValueError, match="0.95"):
            sphere_leadfield(elec, np.array([[0.0, 0.0, 0.089]]),
                             radius=R)
        with pytest.raises(ValueError, match="S, 3"):
            sphere_leadfield(elec, np.zeros((4, 2)))
        with pytest.raises(ValueError, match="orientation"):
            sphere_leadfield(elec, np.zeros((2, 3)),
                             orientation=np.ones((3, 3)))

    def test_fixed_orientation_projects(self):
        elec = fibonacci_electrodes(20, R)
        src = np.array([[0.0, 0.02, 0.05]])
        ori = np.array([[0.0, 0.0, 2.0]])       # normalized internally
        full = np.asarray(sphere_leadfield(elec, src, radius=R))
        fixed = np.asarray(sphere_leadfield(elec, src, radius=R,
                                            orientation=ori))
        np.testing.assert_allclose(fixed[:, 0], full[:, 0, 2],
                                   rtol=1e-5)

    def test_grid_and_cap(self):
        g = source_grid(R, spacing=0.02)
        assert np.linalg.norm(g, axis=1).max() <= 0.85 * R + 1e-9
        cap = fibonacci_electrodes(64, R)
        assert cap.shape == (64, 3) and (cap[:, 2] >= 0).all()
        np.testing.assert_allclose(np.linalg.norm(cap, axis=1), R,
                                   rtol=1e-6)


class TestEndToEnd:
    def test_lcmv_localizes_planted_dipole(self):
        """Self-contained source pipeline: sphere leadfield + our LCMV
        finds the planted dipole on the grid."""
        from ninwavelets_tpu.ops.beamformer import lcmv
        rng = np.random.default_rng(2)
        elec = fibonacci_electrodes(48, R)
        grid = source_grid(R, spacing=0.02, max_eccentricity=0.8)
        lf = np.asarray(sphere_leadfield(elec, grid, radius=R))
        true_idx = int(np.argmin(np.linalg.norm(
            grid - np.array([0.02, -0.01, 0.05]), axis=1)))
        n = 4000
        s = np.sin(2 * np.pi * 11.0 * np.arange(n) / 1000.0)
        ori = np.array([0.3, 0.9, 0.3])
        ori /= np.linalg.norm(ori)
        sig = np.outer(lf[:, true_idx] @ ori, s)
        # 5% sensor noise: keeps the covariance condition inside
        # float32 (a near-rank-1 cov with reg ~1e-7 localizes on CPU
        # but not on an accelerator — same f32, different rounding paths)
        x = (sig + 0.05 * sig.std()
             * rng.standard_normal((48, n))).astype(np.float32)
        cov = (x @ x.T) / n
        res = lcmv(cov, lf.transpose(1, 2, 0), reg=0.005)
        found = int(np.argmax(np.asarray(res.nai)))
        d = np.linalg.norm(grid[found] - grid[true_idx])
        assert d <= 0.021, (found, true_idx, d)


class TestFitDipole:
    """Equivalent-current-dipole fit (`ops.fit_dipole`)."""

    def _plant(self, pos, q, n_elec=64, seed=None, noise=0.0):
        elec = fibonacci_electrodes(n_elec, R)
        v = np.asarray(sphere_leadfield(
            elec, np.asarray(pos)[None], radius=R))[:, 0, :] @ np.asarray(q)
        if noise:
            rng = np.random.default_rng(seed)
            v = v + noise * v.std() * rng.standard_normal(n_elec)
        return elec, v

    def test_exact_recovery(self):
        from ninwavelets_tpu.ops.leadfield import fit_dipole
        pos = np.array([0.021, -0.013, 0.047])
        q = np.array([2.0, -1.0, 3.0]) * 1e-9
        elec, v = self._plant(pos, q)
        res = fit_dipole(v, elec, radius=R)
        assert np.linalg.norm(res["pos"] - pos) < 5e-4      # < 0.5 mm
        assert res["gof"] > 0.9999
        np.testing.assert_allclose(res["moment"], q, rtol=1e-2)

    def test_noise_robustness_and_depths(self):
        from ninwavelets_tpu.ops.leadfield import fit_dipole
        q = np.array([1.0, 2.0, -1.0]) * 1e-9
        for i, pos in enumerate([np.array([0.0, 0.0, 0.02]),
                                 np.array([-0.04, 0.03, 0.03]),
                                 np.array([0.05, 0.0, 0.04])]):
            elec, v = self._plant(pos, q, seed=i, noise=0.05)
            res = fit_dipole(v, elec, radius=R)
            assert np.linalg.norm(res["pos"] - pos) < 4e-3  # < 4 mm
            assert res["gof"] > 0.99

    def test_validation(self):
        from ninwavelets_tpu.ops.leadfield import fit_dipole
        elec = fibonacci_electrodes(16, R)
        with pytest.raises(ValueError, match="zero"):
            fit_dipole(np.zeros(16), elec, radius=R)
        with pytest.raises(ValueError, match="single"):
            fit_dipole(np.zeros((16, 4)), elec, radius=R)
        with pytest.raises(ValueError, match="matching"):
            fit_dipole(np.ones(8), elec, radius=R)

    def test_evoked_timecourse(self):
        from ninwavelets_tpu.ops.leadfield import fit_dipole_evoked
        rng = np.random.default_rng(3)
        pos = np.array([0.02, 0.01, 0.05])
        q0 = np.array([1.0, -2.0, 1.5]) * 1e-9
        elec = fibonacci_electrodes(64, R)
        lf = np.asarray(sphere_leadfield(elec, pos[None],
                                         radius=R))[:, 0, :]
        t = np.arange(200) / 1000.0
        amp = np.exp(-((t - 0.1) / 0.02) ** 2)             # ERP-like
        v_ts = np.outer(lf @ q0, amp)
        v_ts = v_ts + 0.02 * v_ts.std() * rng.standard_normal(v_ts.shape)
        res = fit_dipole_evoked(v_ts, elec, radius=R)
        assert np.linalg.norm(res["pos"] - pos) < 3e-3
        assert abs(res["peak_sample"] - 100) < 5
        # amplitude time course tracks the planted envelope
        a = res["amplitude"] / res["amplitude"].max()
        r = np.corrcoef(a, amp)[0, 1]
        assert r > 0.99
        assert res["gof_ts"][res["peak_sample"]] > 0.99
        with pytest.raises(ValueError, match="E, T"):
            fit_dipole_evoked(np.zeros(64), elec, radius=R)

    def test_guards(self):
        from ninwavelets_tpu.ops.leadfield import fit_dipole
        elec = fibonacci_electrodes(16, R)
        bad = elec.copy()
        bad[3] = 0.0
        with pytest.raises(ValueError, match="origin"):
            fit_dipole(np.ones(16), bad, radius=R)
        with pytest.raises(ValueError, match="0.95"):
            fit_dipole(np.ones(16), elec, radius=R,
                       max_eccentricity=0.99)

    def test_evoked_truncation_consistency(self):
        """The position fit and the time-course leadfield share
        n_terms: the peak-sample gof values must agree."""
        from ninwavelets_tpu.ops.leadfield import fit_dipole_evoked
        pos = np.array([0.01, 0.02, 0.04])
        q0 = np.array([1.0, 1.0, -0.5]) * 1e-9
        elec = fibonacci_electrodes(48, R)
        lf = np.asarray(sphere_leadfield(elec, pos[None],
                                         radius=R))[:, 0, :]
        amp = np.hanning(64)
        v_ts = np.outer(lf @ q0, amp)
        res = fit_dipole_evoked(v_ts, elec, radius=R, n_terms=150)
        pk = res["peak_sample"]
        assert abs(res["gof"] - res["gof_ts"][pk]) < 1e-3
        np.testing.assert_allclose(res["moment_ts"][:, pk],
                                   res["moment"], rtol=2e-2)


class TestMEG:
    """Sarvas MEG leadfield (`ops.sphere_leadfield_meg`)."""

    def test_matches_fd_gradient_of_potential(self):
        """B = -mu0 grad U with U the published magnetic scalar
        potential — a finite-difference gradient is independent of the
        closed-form grad-F algebra."""
        from ninwavelets_tpu.ops.leadfield import sphere_leadfield_meg
        mu0 = 4e-7 * np.pi

        def u(r, r0, q):
            a = r - r0
            an, rn = np.linalg.norm(a), np.linalg.norm(r)
            f = an * (rn * an + rn * rn - r0 @ r)
            return np.cross(q, r0) @ r / (4 * np.pi * f)

        rng = np.random.default_rng(0)
        for _ in range(10):
            r = rng.uniform(-1, 1, 3)
            r = r / np.linalg.norm(r) * 0.12
            r0 = rng.uniform(-0.05, 0.05, 3)
            q = rng.standard_normal(3)
            n = rng.standard_normal(3)
            n /= np.linalg.norm(n)
            h = 1e-6
            g = np.array([(u(r + h * e, r0, q) - u(r - h * e, r0, q))
                          / (2 * h) for e in np.eye(3)])
            want = -mu0 * g @ n
            lf = np.asarray(sphere_leadfield_meg(r[None], n[None],
                                                 r0[None]))
            got = float(lf[0, 0] @ q)
            assert abs(got - want) < 1e-5 * max(abs(want), 1e-30) \
                + 1e-18

    def test_radial_silence_and_center(self):
        from ninwavelets_tpu.ops.leadfield import sphere_leadfield_meg
        rng = np.random.default_rng(1)
        sens = rng.standard_normal((40, 3))
        sens = sens / np.linalg.norm(sens, axis=1, keepdims=True) * 0.12
        ori = rng.standard_normal((40, 3))
        # radial dipole: exactly zero field
        src = np.array([[0.01, -0.02, 0.04]])
        lf = np.asarray(sphere_leadfield_meg(sens, ori, src))
        radial = lf[:, 0, :] @ (src[0] / np.linalg.norm(src[0]))
        tang_scale = np.abs(lf[:, 0, :]).max()
        assert np.abs(radial).max() < 1e-4 * tang_scale
        # center dipole: zero external field entirely
        lfc = np.asarray(sphere_leadfield_meg(sens, ori,
                                              np.zeros((1, 3))))
        assert np.abs(lfc).max() == 0.0

    def test_rotation_equivariance_and_validation(self):
        from ninwavelets_tpu.ops.leadfield import sphere_leadfield_meg
        rng = np.random.default_rng(2)
        a = rng.standard_normal((3, 3))
        qm, _ = np.linalg.qr(a)
        if np.linalg.det(qm) < 0:
            qm[:, 0] *= -1
        sens = fibonacci_electrodes(20, 0.12)
        ori = sens / np.linalg.norm(sens, axis=1, keepdims=True)
        src = np.array([[0.02, 0.01, 0.04]])
        lf = np.asarray(sphere_leadfield_meg(sens, ori, src))
        lf_rot = np.asarray(sphere_leadfield_meg(
            sens @ qm.T, ori @ qm.T, src @ qm.T))
        np.testing.assert_allclose(lf_rot, lf @ qm.T, rtol=2e-3,
                                   atol=1e-6 * np.abs(lf).max())
        with pytest.raises(ValueError, match="outside"):
            sphere_leadfield_meg(0.03 * sens / 0.12, ori, src)
        with pytest.raises(ValueError, match="match"):
            sphere_leadfield_meg(sens, ori[:5], src)

    def test_lcmv_on_meg(self):
        """MEG leadfield drives the same LCMV machinery."""
        from ninwavelets_tpu.ops.beamformer import lcmv
        from ninwavelets_tpu.ops.leadfield import sphere_leadfield_meg
        rng = np.random.default_rng(3)
        sens = fibonacci_electrodes(48, 0.12)
        ori = sens / np.linalg.norm(sens, axis=1, keepdims=True)
        grid = source_grid(0.09, spacing=0.02, max_eccentricity=0.8)
        lf = np.asarray(sphere_leadfield_meg(sens, ori, grid))
        true_idx = int(np.argmin(np.linalg.norm(
            grid - np.array([0.02, -0.01, 0.05]), axis=1)))
        # tangential moment (radial is silent in MEG)
        r0 = grid[true_idx] / np.linalg.norm(grid[true_idx])
        m = np.cross(r0, [0.0, 0.0, 1.0])
        m /= np.linalg.norm(m)
        n = 4000
        s = np.sin(2 * np.pi * 11.0 * np.arange(n) / 1000.0)
        sig = np.outer(lf[:, true_idx] @ m, s)
        x = (sig + 0.05 * sig.std()
             * rng.standard_normal((48, n))).astype(np.float32)
        cov = (x @ x.T) / n
        res = lcmv(cov, lf.transpose(1, 2, 0), reg=0.005)
        found = int(np.argmax(np.asarray(res.nai)))
        assert np.linalg.norm(grid[found] - grid[true_idx]) <= 0.021

    def test_fit_dipole_meg(self):
        from ninwavelets_tpu.ops.leadfield import (fit_dipole_meg,
                                                   sphere_leadfield_meg)
        rng = np.random.default_rng(4)
        sens = fibonacci_electrodes(64, 0.12)
        ori = sens / np.linalg.norm(sens, axis=1, keepdims=True)
        pos = np.array([0.021, -0.013, 0.047])
        r0 = pos / np.linalg.norm(pos)
        q = np.cross(r0, [0.0, 0.0, 1.0])
        q = q / np.linalg.norm(q) * 2e-9        # tangential (observable)
        v = np.asarray(sphere_leadfield_meg(sens, ori,
                                            pos[None]))[:, 0, :] @ q
        vn = v + 0.05 * v.std() * rng.standard_normal(64)
        res = fit_dipole_meg(vn, sens, ori)
        assert np.linalg.norm(res["pos"] - pos) < 3e-3
        assert res["gof"] > 0.99
        np.testing.assert_allclose(res["moment"], q, rtol=0.1,
                                   atol=0.05 * np.linalg.norm(q))
        # the reported moment is tangential by construction
        assert abs(res["moment"] @ (res["pos"]
                   / np.linalg.norm(res["pos"]))) < 1e-12
        with pytest.raises(ValueError, match="outside"):
            fit_dipole_meg(vn, sens * 0.2, ori)
        with pytest.raises(ValueError, match="zero"):
            fit_dipole_meg(np.zeros(64), sens, ori)

    def test_adapter_evoked_fit(self):
        import ninwavelets_tpu as nw
        rng = np.random.default_rng(5)
        pos = np.array([0.015, 0.02, 0.045])
        q0 = np.array([1.0, -1.0, 0.5]) * 1e-9
        elec = fibonacci_electrodes(32, R)
        lf = np.asarray(sphere_leadfield(elec, pos[None],
                                         radius=R))[:, 0, :]
        amp = np.hanning(128)
        e = 20
        trials = (np.outer(lf @ q0, amp)[None]
                  + 0.3e-9 * rng.standard_normal((e, 32, 128))
                  ).astype(np.float32)
        ep = type("E", (), {"_d": trials, "info": {"sfreq": 250.0},
                            "ch_names": [f"c{i}" for i in range(32)],
                            "get_data": lambda s: s._d})()
        ew = nw.EpochsWavelet(ep, nw.Morse(250.0))
        res = ew.fit_dipole(elec, radius=R)
        assert np.linalg.norm(res["pos"] - pos) < 4e-3
        assert res["gof"] > 0.95
        with pytest.raises(ValueError, match="C, 3"):
            ew.fit_dipole(elec[:5], radius=R)

    def test_meg_fit_with_origin_grid_point(self):
        """radius=0.1 with default spacing puts a grid point at the
        exact origin (magnetically silent -> NaN Gram); the fit must
        still return finite results (regression)."""
        from ninwavelets_tpu.ops.leadfield import (fit_dipole_meg,
                                                   sphere_leadfield_meg)
        sens = fibonacci_electrodes(48, 0.14)
        ori = sens / np.linalg.norm(sens, axis=1, keepdims=True)
        pos = np.array([0.02, 0.0, 0.05])
        r0 = pos / np.linalg.norm(pos)
        q = np.cross(r0, [0.0, 1.0, 0.0])
        q = q / np.linalg.norm(q) * 1e-9
        v = np.asarray(sphere_leadfield_meg(sens, ori,
                                            pos[None]))[:, 0, :] @ q
        res = fit_dipole_meg(v, sens, ori, radius=0.1)
        assert np.all(np.isfinite(res["pos"]))
        assert np.isfinite(res["gof"]) and res["gof"] > 0.99
        assert np.linalg.norm(res["pos"] - pos) < 3e-3
