"""GFDL microphysics PSD coefficient setup (setup_mp transcription).

The port's own copy of gfdl_atmos_cubed_sphere_tpu/physics/mp_coeffs.py
(it imports only math). Host-side transcription of FV3
model/gfdl_mp.F90 setup_mp (:728-1114): gamma-distribution moments for
terminal velocities, the Lin et
al. (1983) accretion kernel coefficients (acr2d/acr3d), ventilation
coefficients for rain evaporation / snow + graupel sublimation (crevp,
cssub, cgsub), melt coefficients (csmlt, cgmlt), and the Bigg rain-freezing
coefficients (cgfr). All are pure scalars computed once per MPConfig with
math.gamma — no device work.
"""

import math
from types import SimpleNamespace

# physical constants (gfdl_mp.F90:140-160)
PI = math.pi
VISK = 1.35e-5       # kinematic viscosity of air (m^2/s)
VDIFU = 2.25e-5      # vapor diffusivity (m^2/s)
TCOND = 2.40e-2      # thermal conductivity of air (J/m/s/K)
RHO0 = 1.2
GRAV = 9.80665


def _species(cfg):
    """(n0_sig, n0_exp, mu, alin, blin, rho, con) per species; con is the
    sqrt(4 g rho / (3 cd rho0)) drag factor for graupel/hail."""
    gcon = math.sqrt(4.0 * GRAV * cfg.rhog / (3.0 * 0.5 * RHO0))
    return {
        "qw": (cfg.n0w_sig, cfg.n0w_exp, cfg.muw, cfg.alinw, cfg.blinw,
               cfg.rhow, 1.0),
        "qi": (cfg.n0i_sig, cfg.n0i_exp, cfg.mui, cfg.alini, cfg.blini,
               cfg.rhoi, 1.0),
        "qr": (cfg.n0r_sig, cfg.n0r_exp, cfg.mur, cfg.alinr, cfg.blinr,
               cfg.rhor, 1.0),
        "qs": (cfg.n0s_sig, cfg.n0s_exp, cfg.mus, cfg.alins, cfg.blins,
               cfg.rhos, 1.0),
        "qg": (cfg.n0g_sig, cfg.n0g_exp, cfg.mug, cfg.aling, cfg.bling,
               cfg.rhog, gcon),
    }


def build_coeffs(cfg):
    g = math.gamma
    sp = _species(cfg)

    def norm(name):
        n0_sig, n0_exp, mu, _, _, rho, _ = sp[name]
        return PI * rho * n0_sig * g(mu + 3)

    def expo(name):
        n0_sig, n0_exp, mu, _, _, _, _ = sp[name]
        return math.exp(n0_exp / (mu + 3) * math.log(10.0))

    c = SimpleNamespace()
    c.mu = {k: sp[k][2] for k in sp}
    c.blin = {k: sp[k][4] for k in sp}

    # ---- terminal-velocity moments (setup_mp:823-844) --------------------
    c.tv = {}
    for name in sp:
        n0_sig, n0_exp, mu, alin, blin, rho, con = sp[name]
        tva = (math.exp(-blin / (mu + 3) * math.log(n0_sig)) * alin
               * g(mu + blin + 3)
               * math.exp(-blin * n0_exp / (mu + 3) * math.log(10.0))) * con
        tvb = (math.exp(blin / (mu + 3) * math.log(PI * rho * g(mu + 3)))
               * g(mu + 3))
        c.tv[name] = (tva / tvb, blin / (mu + 3))

    scm3 = math.exp(1.0 / 3.0 * math.log(VISK / VDIFU))
    pisq = PI * PI

    # ---- falling-species x cloud accretion (setup_mp:855-915) ------------
    def cacx(name):
        n0_sig, n0_exp, mu, alin, blin, rho, con = sp[name]
        return (PI * n0_sig * alin * g(2 + mu + blin) * con
                / (4.0 * math.exp((2 + mu + blin) / (mu + 3)
                                  * math.log(norm(name))))
                * math.exp((1 - blin) * math.log(expo(name))))

    c.cracw = cacx("qr") * cfg.c_pracw
    c.craci = cacx("qr") * cfg.c_praci
    c.csacw = cacx("qs") * cfg.c_psacw
    c.csaci = cacx("qs") * cfg.c_psaci
    c.cgacw = cacx("qg") * cfg.c_pgacw
    c.cgaci = cacx("qg") * cfg.c_pgaci

    # ---- falling x falling accretion (setup_mp:918-931) ------------------
    c.cracs = (pisq * sp["qr"][0] * sp["qs"][0] * cfg.rhos / 24.0) * cfg.c_pracs
    c.csacr = (pisq * sp["qs"][0] * sp["qr"][0] * cfg.rhor / 24.0) * cfg.c_psacr
    c.cgacr = (pisq * sp["qg"][0] * sp["qr"][0] * cfg.rhor / 24.0) * cfg.c_pgacr
    c.cgacs = (pisq * sp["qg"][0] * sp["qs"][0] * cfg.rhos / 24.0) * cfg.c_pgacs

    # ---- acr3d moment tables (setup_mp:933-1031) -------------------------
    # pair list k = 1..10: (species1, species2) in the reference's order
    pairs = [("qs", "qr"), ("qr", "qs"), ("qr", "qg"), ("qs", "qg"),
             ("qw", "qr"), ("qi", "qr"), ("qw", "qs"), ("qi", "qs"),
             ("qw", "qg"), ("qi", "qg")]
    act = []
    ace = []
    acc = []
    for s1, s2 in pairs:
        act += [norm(s1), norm(s2)]
        ace += [expo(s1), expo(s2)]
        acc += [sp[s1][2], sp[s2][2]]
    occ = [1.0, 2.0, 1.0]          # setup_mp:1020-1022
    acco = [[0.0] * 10 for _ in range(3)]
    for i in range(1, 4):
        for k in range(1, 11):
            a1 = acc[2 * k - 2]
            a2 = acc[2 * k - 1]
            acco[i - 1][k - 1] = (
                occ[i - 1] * g(6 + a1 - i) * g(a2 + i - 1)
                / (math.exp((6 + a1 - i) / (a1 + 3)
                            * math.log(act[2 * k - 2]))
                   * math.exp((a2 + i - 1) / (a2 + 3)
                              * math.log(act[2 * k - 1])))
                * math.exp((i - 3) * math.log(ace[2 * k - 2]))
                * math.exp((4 - i) * math.log(ace[2 * k - 1])))
    c.acco = acco
    c.acc = acc

    # ---- ventilation/evaporation coefficients (setup_mp:1035-1078) -------
    def vent5(name, rvgas):
        n0_sig, n0_exp, mu, alin, blin, rho, con = sp[name]
        c1 = (2.0 * PI * VDIFU * TCOND * rvgas * n0_sig * g(1 + mu)
              / math.exp((1 + mu) / (mu + 3) * math.log(norm(name)))
              * math.exp(2.0 * math.log(expo(name))))
        c3 = (0.31 * scm3 * math.sqrt(alin * con / VISK)
              * g((3 + 2 * mu + blin) / 2)
              / math.exp((3 + 2 * mu + blin) / (mu + 3) / 2
                         * math.log(norm(name)))
              * math.exp((1 + mu) / (mu + 3) * math.log(norm(name)))
              / g(1 + mu)
              * math.exp((-1 - blin) / 2.0 * math.log(expo(name))))
        return [c1, 0.78, c3, TCOND * rvgas, VDIFU]

    rvgas = 461.50
    c.crevp = vent5("qr", rvgas)
    c.cssub = vent5("qs", rvgas)
    c.cgsub = vent5("qg", rvgas)

    # ---- melt coefficients (setup_mp:1081-1105) --------------------------
    def melt4(name, sub5):
        n0_sig, n0_exp, mu, _, _, _, _ = sp[name]
        c1 = (2.0 * PI * TCOND * n0_sig * g(1 + mu)
              / math.exp((1 + mu) / (mu + 3) * math.log(norm(name)))
              * math.exp(2.0 * math.log(expo(name))))
        c2 = (2.0 * PI * VDIFU * n0_sig * g(1 + mu)
              / math.exp((1 + mu) / (mu + 3) * math.log(norm(name)))
              * math.exp(2.0 * math.log(expo(name))))
        return [c1, c2, sub5[1], sub5[2]]

    c.csmlt = melt4("qs", c.cssub)
    c.cgmlt = melt4("qg", c.cgsub)

    # ---- Bigg rain freezing (setup_mp:1110-1112) -------------------------
    c.cgfr = [
        1.0e2 / 36 * pisq * sp["qr"][0] * cfg.rhor * g(6 + sp["qr"][2])
        / math.exp((6 + sp["qr"][2]) / (sp["qr"][2] + 3)
                   * math.log(norm("qr")))
        * math.exp(-3.0 * math.log(expo("qr"))),
        0.66,
    ]
    return c
