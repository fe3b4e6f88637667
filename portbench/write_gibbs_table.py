"""Write the frozen thermochemical data of the equilibrium reference
(portbench/torch_reference/): G/RT of a configuration's species on a
temperature grid, and its elements with their solar abundances, from
published data entered below, in plain numpy.  It imports nothing of
pyratbay_tpu_torch or pyratbay_tpu.

    python3 portbench/write_gibbs_table.py [<config.json>]

writes the configuration's `chemistry.gibbs_file` (default: the
equilibrium flagship's) and prints its sha256, which
torch_reference/flagship_eq.py holds as GIBBS_SHA256.  Written once and
committed; the reference reads these numbers and nothing else.

The data, each with its source:
* Constants: CODATA 2018 (Tiesinga et al. 2021, Rev. Mod. Phys. 93,
  025010); the standard state is the ideal gas at 1 bar.
* Molecules (H2, H2O, CH4, CO, CO2): the NASA 7-term polynomials of
  GRI-Mech 3.0's thermo30.dat (Smith et al. 1999), copied in the file's
  order (the upper range, then the lower; 200-1000-3500 K).  Their
  standard state is 1 bar: their S(298.15 K) are the CODATA key values
  at 1 bar (Cox, Wagman & Medvedev 1989) to within 0.12 J/mol/K, where
  1 atm would put them 0.109 J/mol/K lower.  Above 3,500 K the upper
  polynomial is extended (the grid's top, 6,000 K, lies beyond every
  layer the configuration keeps: thigh = 3,000 K).
* Atoms (H, He, Na, K): the ideal monatomic gas (Sackur-Tetrode) with
  the electronic partition function of the NIST Atomic Spectra
  Database's levels (fine structure resolved) up to the first level
  whose Boltzmann factor at 3,000 K is below 1e-5 of the ground's
  (Na 5s at 33,200.7 cm-1, K 4d at 27,397.1 cm-1, H n = 2 and He 1s2s
  left out); enthalpies of formation at 298.15 K from the CODATA key
  values; masses the CIAAW standard atomic weights (conventional values
  for H).
* Solar abundances: Asplund, Amarsi & Grevesse (2021), A&A 653, A141,
  table 2 (log eps, H = 12).
* The configuration's chemcat-parity corrections, stated there with
  their source: `chemistry.g0_offsets`, g0 += ds + dh / T per species
  (ds in units of R, dh in K), and `g0_fit_gri_pressure_pa`, the
  pressure at which the fit read GRI-Mech's polynomials (1 atm): their
  G/RT at 1 bar is then lower by ln(p / 1 bar).  The offsets were fitted
  on that reading and bring the equilibria near chemcat's only with it.
"""
import hashlib
import json
import os
import re
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# CODATA 2018 (exact in the SI since 2019, but the atomic mass unit):
H_PLANCK = 6.62607015e-34       # J s
K_BOLTZ = 1.380649e-23          # J / K
N_AVOGADRO = 6.02214076e23      # 1 / mol
C_LIGHT = 299792458.0           # m / s
AMU = 1.66053906660e-27         # kg
R_GAS = N_AVOGADRO * K_BOLTZ    # J / mol / K
C2_CM = 100.0 * H_PLANCK * C_LIGHT / K_BOLTZ     # K cm (second radiation)
P_STD = 1.0e5                   # Pa
T_REF = 298.15                  # K

# GRI-Mech 3.0 thermo30.dat: name -> (T_mid, upper a1-a7, lower a1-a7):
GRI30 = {
    'H2': (1000.0,
           (3.33727920e+00, -4.94024731e-05, 4.99456778e-07,
            -1.79566394e-10, 2.00255376e-14, -9.50158922e+02,
            -3.20502331e+00),
           (2.34433112e+00, 7.98052075e-03, -1.94781510e-05,
            2.01572094e-08, -7.37611761e-12, -9.17935173e+02,
            6.83010238e-01)),
    'H2O': (1000.0,
            (3.03399249e+00, 2.17691804e-03, -1.64072518e-07,
             -9.70419870e-11, 1.68200992e-14, -3.00042971e+04,
             4.96677010e+00),
            (4.19864056e+00, -2.03643410e-03, 6.52040211e-06,
             -5.48797062e-09, 1.77197817e-12, -3.02937267e+04,
             -8.49032208e-01)),
    'CH4': (1000.0,
            (7.48514950e-02, 1.33909467e-02, -5.73285809e-06,
             1.22292535e-09, -1.01815230e-13, -9.46834459e+03,
             1.84373180e+01),
            (5.14987613e+00, -1.36709788e-02, 4.91800599e-05,
             -4.84743026e-08, 1.66693956e-11, -1.02466476e+04,
             -4.64130376e+00)),
    'CO': (1000.0,
           (2.71518561e+00, 2.06252743e-03, -9.98825771e-07,
            2.30053008e-10, -2.03647716e-14, -1.41518724e+04,
            7.81868772e+00),
           (3.57953347e+00, -6.10353680e-04, 1.01681433e-06,
            9.07005884e-10, -9.04424499e-13, -1.43440860e+04,
            3.50840928e+00)),
    'CO2': (1000.0,
            (3.85746029e+00, 4.41437026e-03, -2.21481404e-06,
             5.23490188e-10, -4.72084164e-14, -4.87591660e+04,
             2.27163806e+00),
            (2.35677352e+00, 8.98459677e-03, -7.12356269e-06,
             2.45919022e-09, -1.43699548e-13, -4.83719697e+04,
             9.90105222e+00)),
}

# Atoms: name -> (mass [u], DfH(298.15 K) [kJ/mol], ((E [cm-1], g), ...)):
ATOMS = {
    'H': (1.008, 217.998, ((0.0, 2),)),
    'He': (4.002602, 0.0, ((0.0, 1),)),
    'Na': (22.98976928, 107.5,
           ((0.0, 2),                                   # 3s 2S1/2
            (16956.1703, 2), (16973.3661, 4),           # 3p 2P
            (25739.9990, 2),                            # 4s 2S1/2
            (29172.8387, 6), (29172.8548, 4),           # 3d 2D5/2, 3/2
            (30266.9900, 2), (30272.5800, 4))),         # 4p 2P
    'K': (39.0983, 89.0,
          ((0.0, 2),                                    # 4s 2S1/2
           (12985.1857, 2), (13042.8960, 4),            # 4p 2P
           (21026.5510, 2),                             # 5s 2S1/2
           (21534.6800, 6), (21536.9880, 4),            # 3d 2D5/2, 3/2
           (24701.3820, 2), (24720.1390, 4))),          # 5p 2P
}

# Asplund, Amarsi & Grevesse (2021), table 2:
SOLAR_DEX = {'asplund_2021': {'H': 12.00, 'He': 10.914, 'C': 8.46,
                              'O': 8.69, 'Na': 6.22, 'K': 5.07}}

# The grid, every 2 K (G/RT is lerped on it):
TEMPERATURE = np.arange(200.0, 6001.0, 2.0)

_FORMULA = re.compile(r'([A-Z][a-z]?)(\d*)')


def nasa7(name, temp):
    """(H/RT, S/R) of a GRI-Mech 3.0 species at temp [K]."""
    tmid, upper, lower = GRI30[name]
    a = np.where((temp < tmid)[:, None], np.array(lower)[None],
                 np.array(upper)[None])
    powers = np.stack([temp ** k for k in range(5)], axis=1)
    h = (powers * a[:, :5] / np.arange(1, 6)).sum(axis=1) + a[:, 5] / temp
    s = a[:, 0] * np.log(temp) + (powers[:, 1:] * a[:, 1:5]
                                  / np.arange(1, 5)).sum(axis=1) + a[:, 6]
    return h, s


def atom(name, temp):
    """(H/RT, S/R) of an ideal monatomic gas at temp [K], H referenced
    to the elements at 298.15 K."""
    mass, dfh, levels = ATOMS[name]
    energy = C2_CM * np.array([e for e, _ in levels])        # K
    weight = np.array([g for _, g in levels], float)

    def electronic(t):
        """(ln Q, <E> / kT)."""
        boltz = weight[None] * np.exp(-energy[None] / t[:, None])
        q = boltz.sum(axis=1)
        return np.log(q), (boltz * energy[None]).sum(axis=1) / q / t

    ln_q, e_kt = electronic(temp)
    ln_q0, e_kt0 = electronic(np.array([T_REF]))
    m = mass * AMU
    s_trans = (1.5 * np.log(2.0 * np.pi * m * K_BOLTZ * temp / H_PLANCK**2)
               + np.log(K_BOLTZ * temp / P_STD) + 2.5)
    h = (dfh * 1e3 / (R_GAS * temp) + 2.5 * (1.0 - T_REF / temp)
         + e_kt - e_kt0[0] * T_REF / temp)
    return h, s_trans + ln_q + e_kt


def gibbs_over_rt(name, temp, chemistry=None):
    """G/RT at 1 bar of a species at temp [K], with the corrections of a
    configuration's `chemistry` where it has them."""
    chemistry = chemistry or {}
    temp = np.asarray(temp, float)
    if name in GRI30:
        h, s = nasa7(name, temp)
        s = s + np.log(chemistry.get('g0_fit_gri_pressure_pa', P_STD)
                       / P_STD)
    else:
        h, s = atom(name, temp)
    ds, dh = chemistry.get('g0_offsets', {}).get(name, (0.0, 0.0))
    return h - s + ds + dh / temp


def elements_of(species):
    """The network's elements, in the order they first appear."""
    out = []
    for name in species:
        for element, _ in _FORMULA.findall(name):
            if element not in out:
                out.append(element)
    return out


def table(config):
    """The arrays of the file: species, temperature [nT], gibbs_over_rt
    [nT, ns], elements and solar_dex (in the elements' order)."""
    chemistry = config['chemistry']
    species = list(config['species'])
    gibbs = np.stack([gibbs_over_rt(s, TEMPERATURE, chemistry)
                      for s in species], axis=1)
    elements = elements_of(species)
    solar = SOLAR_DEX[chemistry['solar']]
    return {'species': np.array(species), 'temperature': TEMPERATURE,
            'gibbs_over_rt': gibbs, 'elements': np.array(elements),
            'solar_dex': np.array([solar[e] for e in elements])}


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    path = argv[0] if argv else os.path.join(
        ROOT, 'portbench', 'configs', 'flagship_eq.json')
    with open(path) as f:
        config = json.load(f)
    out = os.path.join(ROOT, config['chemistry']['gibbs_file'])
    with open(out, 'wb') as f:
        np.savez(f, **table(config))
    with open(out, 'rb') as f:
        print(hashlib.sha256(f.read()).hexdigest())
    return 0


if __name__ == '__main__':
    sys.exit(main())
