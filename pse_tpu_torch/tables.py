"""Real-space Ewald-split RPY pair mobility functions, in float64 on the host.

UF1 ("Imrr", the coefficient of the identity part) and UF2 ("rr", the
coefficient of the longitudinal r-hat r-hat part) of the real-space (screened)
Ewald-split Rotne-Prager-Yamakawa mobility of equal spheres of radius ``a``:

    u_i += UF1(r) * F_j + (UF2(r) - UF1(r)) * (r-hat . F_j) r-hat

in units where 6*pi*eta*a = a.  The expressions are those of Fiore, Balboa
Usabiaga, Donev & Swan, J. Chem. Phys. 146, 124116 (2017), with three
branches (separated, touching, overlapping).  They cancel catastrophically in
float32, so they are evaluated in float64 with numpy; ops/chebyshev.py fits
them once per configuration and the device only evaluates the fits.

This is a numpy copy of the JAX package's ``tables.py`` (the port imports
nothing from that package): the table builder used only by its gather engine
is left out.
"""

from __future__ import annotations

import numpy as np
from scipy.special import erfc

SQRT_PI = float(np.sqrt(np.pi))


def self_mobility(xi: float, a: float = 1.0) -> float:
    """ξ-dependent self-mobility of the real-space part (Stokes.cc:315-319)."""
    axi = a * xi
    return float(
        (1.0 + 4.0 * SQRT_PI * axi * erfc(2.0 * axi) - np.exp(-4.0 * axi * axi))
        / (4.0 * SQRT_PI * axi * a)
    )


def real_space_pair_functions(r, xi: float, a: float = 1.0):
    """Evaluate (UF1, UF2) at distances ``r`` in float64.

    Branches: r > 2a (separated), r == 2a (touching), r < 2a (overlapping).
    Formulas from Fiore et al. (2017); cf. reference Stokes.cc:334-412.
    """
    r = np.asarray(r, dtype=np.float64)
    xi = float(xi)
    a = float(a)
    Pi = np.pi
    spi = 1.0 / np.sqrt(Pi)  # Pi^{-1/2}

    xi2 = xi * xi
    xim4 = xi ** -4.0
    xim3 = xi ** -3.0

    with np.errstate(over="ignore", under="ignore"):
        rm1 = 1.0 / r
        rm2 = rm1 * rm1
        rm3 = rm2 * rm1
        r2 = r * r
        r3 = r2 * r
        r4 = r2 * r2

        am1 = 1.0 / a
        am2 = am1 * am1
        a2 = a * a
        a3 = a2 * a

        erfc_r = erfc(r * xi)
        erfc_2apr = erfc((2.0 * a + r) * xi)
        erfc_2amr = erfc((2.0 * a - r) * xi)      # = erfc(2 a xi - r xi)
        erfc_rm2a = erfc((r - 2.0 * a) * xi)      # = erfc((-2a + r) xi)
        exp_r = np.exp(-r2 * xi2)
        exp_2apr = np.exp(-((2.0 * a + r) ** 2) * xi2)
        exp_rm2a = np.exp(-((r - 2.0 * a) ** 2) * xi2)

        # ---- branch r > 2a -------------------------------------------------
        imrr_far = (
            -am1
            + (a2 * rm3) / 2.0
            + (3.0 * rm1) / 4.0
            + (3.0 * erfc_r * am2 * rm3 * (-12.0 * r4 + xim4)) / 128.0
            + am2 * ((9.0 * r) / 32.0 - (3.0 * rm3 * xim4) / 128.0)
            + (
                erfc_2apr
                * (128.0 * am1 + 64.0 * a2 * rm3 + 96.0 * rm1 + am2 * (36.0 * r - 3.0 * rm3 * xim4))
            )
            / 256.0
            + (
                erfc_2amr
                * (128.0 * am1 - 64.0 * a2 * rm3 - 96.0 * rm1 + am2 * (-36.0 * r + 3.0 * rm3 * xim4))
            )
            / 256.0
            + (3.0 * exp_r * am2 * spi * rm2 * xim3 * (1.0 + 6.0 * r2 * xi2)) / 64.0
            + (
                exp_2apr
                * am2
                * spi
                * rm3
                * xim3
                * (
                    8.0 * r * a2 * xi2
                    - 16.0 * a3 * xi2
                    + a * (2.0 - 28.0 * r2 * xi2)
                    - 3.0 * (r + 6.0 * r3 * xi2)
                )
            )
            / 128.0
            + (
                exp_rm2a
                * am2
                * spi
                * rm3
                * xim3
                * (
                    8.0 * r * a2 * xi2
                    + 16.0 * a3 * xi2
                    + a * (-2.0 + 28.0 * r2 * xi2)
                    - 3.0 * (r + 6.0 * r3 * xi2)
                )
            )
            / 128.0
        )

        rr_far = (
            -am1
            - a2 * rm3
            + (3.0 * rm1) / 2.0
            + (3.0 * am2 * rm3 * (4.0 * r4 + xim4)) / 64.0
            + (
                erfc_2amr
                * (64.0 * am1 + 64.0 * a2 * rm3 - 96.0 * rm1 + am2 * (-12.0 * r - 3.0 * rm3 * xim4))
            )
            / 128.0
            + (
                erfc_2apr
                * (64.0 * am1 - 64.0 * a2 * rm3 + 96.0 * rm1 + am2 * (12.0 * r + 3.0 * rm3 * xim4))
            )
            / 128.0
            + (3.0 * exp_r * am2 * spi * rm2 * xim3 * (-1.0 + 2.0 * r2 * xi2)) / 32.0
            - (
                (2.0 * a + 3.0 * r)
                * exp_rm2a
                * am2
                * spi
                * rm3
                * xim3
                * (-1.0 - 8.0 * a * r * xi2 + 8.0 * a2 * xi2 + 2.0 * r2 * xi2)
            )
            / 64.0
            + (
                (2.0 * a - 3.0 * r)
                * exp_2apr
                * am2
                * spi
                * rm3
                * xim3
                * (-1.0 + 8.0 * a * r * xi2 + 8.0 * a2 * xi2 + 2.0 * r2 * xi2)
            )
            / 64.0
            - (3.0 * erfc_r * am2 * rm3 * xim4 * (1.0 + 4.0 * r4 * xi ** 4)) / 64.0
        )

        # ---- branch r == 2a ------------------------------------------------
        am4 = am2 * am2
        am5 = am4 * am1
        a4 = a2 * a2
        erfc_2axi = erfc(2.0 * a * xi)
        erfc_4axi = erfc(4.0 * a * xi)
        exp_16 = np.exp(-16.0 * a2 * xi2)
        exp_4 = np.exp(-4.0 * a2 * xi2)

        imrr_touch = (
            -(am5 * (3.0 + 16.0 * a * xi * spi) * xim4) / 2048.0
            + (3.0 * erfc_2axi * am5 * (-192.0 * a4 + xim4)) / 1024.0
            + erfc_4axi * (am1 - (3.0 * am5 * xim4) / 2048.0)
            + (exp_16 * am4 * spi * xim3 * (-1.0 - 64.0 * a2 * xi2)) / 256.0
            + (3.0 * exp_4 * am4 * spi * xim3 * (1.0 + 24.0 * a2 * xi2)) / 256.0
        )

        rr_touch = (
            (am5 * (3.0 + 16.0 * a * xi * spi) * xim4) / 1024.0
            + erfc_2axi * ((-3.0 * am1) / 8.0 - (3.0 * am5 * xim4) / 512.0)
            + erfc_4axi * (am1 + (3.0 * am5 * xim4) / 1024.0)
            + (exp_16 * am4 * spi * xim3 * (1.0 - 32.0 * a2 * xi2)) / 128.0
            + (3.0 * exp_4 * am4 * spi * xim3 * (-1.0 + 8.0 * a2 * xi2)) / 128.0
        )

        # ---- branch r < 2a -------------------------------------------------
        imrr_near = (
            (-9.0 * r * am2) / 32.0
            + am1
            - (a2 * rm3) / 2.0
            - (3.0 * rm1) / 4.0
            + (3.0 * erfc_r * am2 * rm3 * (-12.0 * r4 + xim4)) / 128.0
            + (
                erfc_rm2a
                * (-128.0 * am1 + 64.0 * a2 * rm3 + 96.0 * rm1 + am2 * (36.0 * r - 3.0 * rm3 * xim4))
            )
            / 256.0
            + (
                erfc_2apr
                * (128.0 * am1 + 64.0 * a2 * rm3 + 96.0 * rm1 + am2 * (36.0 * r - 3.0 * rm3 * xim4))
            )
            / 256.0
            + (3.0 * exp_r * am2 * spi * rm2 * xim3 * (1.0 + 6.0 * r2 * xi2)) / 64.0
            + (
                exp_2apr
                * am2
                * spi
                * rm3
                * xim3
                * (
                    8.0 * r * a2 * xi2
                    - 16.0 * a3 * xi2
                    + a * (2.0 - 28.0 * r2 * xi2)
                    - 3.0 * (r + 6.0 * r3 * xi2)
                )
            )
            / 128.0
            + (
                exp_rm2a
                * am2
                * spi
                * rm3
                * xim3
                * (
                    8.0 * r * a2 * xi2
                    + 16.0 * a3 * xi2
                    + a * (-2.0 + 28.0 * r2 * xi2)
                    - 3.0 * (r + 6.0 * r3 * xi2)
                )
            )
            / 128.0
        )

        rr_near = (
            ((2.0 * a + 3.0 * r) * am2 * (2.0 * a - r) ** 3 * rm3) / 16.0
            + (
                erfc_rm2a
                * (-64.0 * am1 - 64.0 * a2 * rm3 + 96.0 * rm1 + am2 * (12.0 * r + 3.0 * rm3 * xim4))
            )
            / 128.0
            + (
                erfc_2apr
                * (64.0 * am1 - 64.0 * a2 * rm3 + 96.0 * rm1 + am2 * (12.0 * r + 3.0 * rm3 * xim4))
            )
            / 128.0
            + (3.0 * exp_r * am2 * spi * rm2 * xim3 * (-1.0 + 2.0 * r2 * xi2)) / 32.0
            - (
                (2.0 * a + 3.0 * r)
                * exp_rm2a
                * am2
                * spi
                * rm3
                * xim3
                * (-1.0 - 8.0 * a * r * xi2 + 8.0 * a2 * xi2 + 2.0 * r2 * xi2)
            )
            / 64.0
            + (
                (2.0 * a - 3.0 * r)
                * exp_2apr
                * am2
                * spi
                * rm3
                * xim3
                * (-1.0 + 8.0 * a * r * xi2 + 8.0 * a2 * xi2 + 2.0 * r2 * xi2)
            )
            / 64.0
            - (3.0 * erfc_r * am2 * rm3 * xim4 * (1.0 + 4.0 * r4 * xi ** 4)) / 64.0
        )

    imrr = np.where(r > 2.0 * a, imrr_far, np.where(r == 2.0 * a, imrr_touch, imrr_near))
    rr = np.where(r > 2.0 * a, rr_far, np.where(r == 2.0 * a, rr_touch, rr_near))
    return imrr, rr
