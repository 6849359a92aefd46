"""The Adam-aware gate for comparing two training trajectories, shared by
the tests, the multichip dry-run and chip_smoke.py."""


def assert_trajectory_close(got, want, lr, rtol=5e-3, atol=5e-4,
                            outlier_frac=0.005):
    """Cross-PROGRAM training-trajectory comparison robust to Adam sign
    flips.

    Two different compiled programs (mesh vs single device, grouped vs
    split kernels, ...) produce reduction-order-ulp gradient differences,
    and Adam's normalized step maps any NEAR-ZERO gradient to +-lr
    regardless of ulp size -- a tiny fraction of elements can
    legitimately drift a few lr over a short run (mechanics measured in
    PARITY round-5's supervised-coverage note; observed ~1/100s of runs
    in the driver dryrun before it gained the same gate). Every element
    must stay within a few-sign-flips absolute bound (10 * lr) and at
    most ``outlier_frac`` may exceed the tight accumulation-level
    tolerance; a real structural bug moves whole tensors by O(0.1-1),
    far outside both."""
    import numpy as np
    got, want = np.asarray(got), np.asarray(want)
    d = np.abs(got - want)
    loose = 10 * lr
    assert d.max() <= loose, f"max|d|={d.max():.3e} > {loose:.1e}"
    frac = (d > (rtol * np.abs(want) + atol)).mean()
    assert frac <= outlier_frac, \
        f"{frac:.2%} of elements outside rtol {rtol} (max|d|={d.max():.3e})"
