"""Theorem 1 / Corollary 1 numerics: LR decay ≡ batch ramp on noisy
linear regression, via the exact bias/variance recursions AND a real
sampled-SGD run (both directions of the equivalence).  The recursions
are host numpy (``core.theory``); the sampled SGD runs in torch float64
on ``--device``.

    python -m repro_torch.examples.linear_regression_equivalence
        [--device cpu]
"""
import argparse
import math

import numpy as np
import torch

from repro_torch.core import theory as T
from repro_torch.data import LinearRegressionSampler


def exact_recursions():
    """The three risk ratios: Theorem 1, Corollary 1, mismatched."""
    print("== exact recursions (Section 5) ==")
    lam = T.power_law_spectrum(100, a=1.0)
    eta = T.stability_eta(lam)
    m0 = T.warm_start(lam, 1.0, eta, 8, 2000)
    samples = [4096] * 6

    r = T.theorem1_risk_ratio(lam, 1.0, eta0=eta, b0=8, alpha1=4.0,
                              beta1=1.0, alpha2=2.0, beta2=2.0,
                              samples_per_phase=samples, m_start=m0)
    print(f"Theorem 1  (SGD,  αβ matched 4·1 = 2·2):   risk ratio {r:.4f}")

    eta_n = eta * math.sqrt(np.sum(lam) / 8)
    r2 = T.corollary1_risk_ratio(lam, 1.0, eta0=eta_n, b0=8, alpha1=2.0,
                                 beta1=1.0, alpha2=math.sqrt(2),
                                 beta2=2.0, samples_per_phase=samples,
                                 m_start=m0)
    print(f"Corollary 1 (NSGD, α√β matched 2 = √2·√2): risk ratio "
          f"{r2:.4f}")

    bad = T.theorem1_risk_ratio(lam, 1.0, eta0=eta, b0=8, alpha1=4.0,
                                beta1=1.0, alpha2=1.2, beta2=1.0,
                                samples_per_phase=samples, m_start=m0)
    print(f"mismatched products (4 vs 1.2):            risk ratio {bad:.4f}")
    return r, r2, bad


def sampled_sgd(seed: int = 0, device: str = "cuda"):
    """Returns ((risk, serial steps) of (α,β)=(4,1), the same of (2,2))."""
    print("\n== sampled SGD (same equivalence, real noise) ==")
    d = 50
    lam = T.power_law_spectrum(d, a=1.0)
    sampler = LinearRegressionSampler(lam, sigma2=0.25, seed=seed)
    rng = np.random.default_rng(seed)
    w0 = rng.normal(size=d) / np.sqrt(d)
    eta0 = T.stability_eta(lam) * 5

    def run(alpha, beta, phases=5, samples_per_phase=20000, b0=10):
        w = torch.tensor(w0, dtype=torch.float64, device=device)
        step_idx = 0
        for k in range(phases):
            B = int(b0 * beta ** k)
            eta = eta0 * alpha ** (-k)
            for _ in range(samples_per_phase // B):
                x, y = (torch.from_numpy(a).to(device, torch.float64)
                        for a in sampler.sample(step_idx, B))
                g = x.T @ (x @ w - y) / B
                w = w - eta * g
                step_idx += 1
        return sampler.risk(w.cpu().numpy()), step_idx

    r1, s1 = run(4.0, 1.0)
    r2, s2 = run(2.0, 2.0)
    print(f"(α,β)=(4,1): risk {r1:.5f}  serial steps {s1}")
    print(f"(α,β)=(2,2): risk {r2:.5f}  serial steps {s2} "
          f"({1 - s2/s1:.0%} fewer)")
    print(f"ratio {r1/r2:.3f} (→ 1 means equivalent, Theorem 1)")
    return (r1, s1), (r2, s2)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" \
            and not torch.cuda.is_available():
        raise RuntimeError("--device cuda but no CUDA device is present; "
                           "pass --device cpu")
    return exact_recursions(), sampled_sgd(device=args.device)


if __name__ == "__main__":
    main()
