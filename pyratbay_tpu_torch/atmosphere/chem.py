"""Thermochemical-equilibrium chemistry: host thermodynamic data and a
batched equilibrium solve in torch.

Port of pyratbay_tpu/atmosphere/chem.py.  The element masses, solar
abundances, NASA-7 and statistical-mechanics data and the host
functions (parse_formula, species_mass, has_thermo, thermo_properties,
gibbs_over_rt, read_solar_file) are copied as host numpy float64; the
chemcat-parity G/RT calibration comes with them (PBT_CHEM_CAL=0 at
import, or CALIBRATE_G0 = False, turns it off).  G/RT is tabulated per
species on _T_GRID (200-6000 K, step 2) once per Network, on the host.

The solver is the reference's CEA Gibbs descent (damped Newton steps on
the element-potential dual, one (nelem+1)-square system per layer),
written over any leading batch axes: equilibrium_vmr solves every
[chain, layer] system of a retrieval at once, with the same 120 damped
steps, then 32 steps whose log-abundances are averaged, the same Jacobi
scaling, 1e-12 regularisation, step limit lam = min(1, 2/step) and clip
to [ln_ntot - 70, ln_ntot + 2].

* The solve runs in float64 on every device, float32 callers included;
  the VMRs are cast to the caller's dtype at the end.  A retrieval's
  systems are ~7 x 7 (26,112 of them at 512 chains x 51 layers), so
  float64 costs little on the card, and it avoids the float32 rattle
  near convergence that the averaged tail exists to damp (the tail is
  kept, for parity).
* On the CPU the linear solve is torch.linalg.solve_ex on the scaled
  systems: the reference writes its own Gauss-Jordan only because the
  TPU's LU has no float64.
* On the card the whole solve is one launch of csrc/chem_gibbs.cu
  (equilibrium_cuda), for equilibrium_vmr on CUDA tensors and for
  equilibrium_fn on a CUDA device, where the kernel also makes G/RT and
  the element budget from the temperatures and the chains' parameters.
  It takes networks of up to CHEM_MAX_SPECIES species and CHEM_MAX_COLS
  element columns (elements and the charge column) and raises ValueError
  above them; no CUDA tensor falls back to the torch steps.  Neither path
  reads a device value on the host.
"""
import ctypes
import functools
import os
import re

import numpy as np
import torch

__all__ = [
    'Network', 'chemistry', 'ELEMENT_MASS', 'SOLAR_ABUNDANCES',
    'has_thermo', 'supported_species', 'read_solar_file',
    'equilibrium_fn', 'hybrid_max_vmr', 'equilibrium_vmr',
    'equilibrium_cuda', 'check_kernel_size', 'CHEM_MAX_SPECIES',
    'CHEM_MAX_COLS', 'CHEM_MAX_RATIOS',
    'thermo_properties', 'gibbs_over_rt', 'parse_formula',
    'species_mass',
]

# Physical constants (SI; CODATA 2018):
_H_PLANCK = 6.62607015e-34     # J s
_K_BOLTZ = 1.380649e-23        # J / K
_N_AVOG = 6.02214076e23        # 1 / mol
_R_GAS = 8.314462618           # J / mol / K
_AMU = 1.66053906660e-27       # kg
_C2_CM = 1.4387768775          # K cm  (hc/k)
_P_STD = 1.0e5                 # Pa; standard state (1 bar)
_T_REF = 298.15                # K
_E_MASS = 5.48579909065e-4     # electron mass (u)

# ---------------------------------------------------------------------
# Elemental data

ELEMENT_MASS = {
    'H': 1.008, 'He': 4.002602, 'C': 12.011, 'N': 14.007, 'O': 15.999,
    'Na': 22.98976928, 'Mg': 24.305, 'Al': 26.9815385, 'Si': 28.085,
    'P': 30.973762, 'S': 32.06, 'Cl': 35.45, 'K': 39.0983, 'Ca': 40.078,
    'Ti': 47.867, 'V': 50.9415, 'Cr': 51.9961, 'Mn': 54.938044,
    'Fe': 55.845, 'Ni': 58.6934,
}

# log10 n_X/n_H + 12 photospheric abundances:
SOLAR_ABUNDANCES = {
    # Asplund, Grevesse, Sauval & Scott (2009), ARA&A 47, 481:
    'asplund_2009': {
        'H': 12.00, 'He': 10.93, 'C': 8.43, 'N': 7.83, 'O': 8.69,
        'Na': 6.24, 'Mg': 7.60, 'Al': 6.45, 'Si': 7.51, 'P': 5.41,
        'S': 7.12, 'Cl': 5.50, 'K': 5.03, 'Ca': 6.34, 'Ti': 4.95,
        'V': 3.93, 'Cr': 5.64, 'Mn': 5.43, 'Fe': 7.50, 'Ni': 6.22,
    },
    # Asplund, Amarsi & Grevesse (2021), A&A 653, A141:
    'asplund_2021': {
        'H': 12.00, 'He': 10.914, 'C': 8.46, 'N': 7.83, 'O': 8.69,
        'Na': 6.22, 'Mg': 7.55, 'Al': 6.43, 'Si': 7.51, 'P': 5.41,
        'S': 7.12, 'Cl': 5.31, 'K': 5.07, 'Ca': 6.30, 'Ti': 4.97,
        'V': 3.90, 'Cr': 5.62, 'Mn': 5.42, 'Fe': 7.46, 'Ni': 6.20,
    },
}

# ---------------------------------------------------------------------
# NASA-7 polynomial data (GRI-Mech 3.0): species -> (Tmid, low, high)
# cp/R = a1 + a2 T + a3 T^2 + a4 T^3 + a5 T^4
# H/RT = a1 + a2 T/2 + ... + a6/T;  S/R = a1 lnT + a2 T + ... + a7

_NASA7 = {
    'H2': (1000.0,
        (2.34433112e+00, 7.98052075e-03, -1.94781510e-05, 2.01572094e-08,
         -7.37611761e-12, -9.17935173e+02, 6.83010238e-01),
        (3.33727920e+00, -4.94024731e-05, 4.99456778e-07, -1.79566394e-10,
         2.00255376e-14, -9.50158922e+02, -3.20502331e+00)),
    'O2': (1000.0,
        (3.78245636e+00, -2.99673416e-03, 9.84730201e-06, -9.68129509e-09,
         3.24372837e-12, -1.06394356e+03, 3.65767573e+00),
        (3.28253784e+00, 1.48308754e-03, -7.57966669e-07, 2.09470555e-10,
         -2.16717794e-14, -1.08845772e+03, 5.45323129e+00)),
    'OH': (1000.0,
        (3.99201543e+00, -2.40131752e-03, 4.61793841e-06, -3.88113333e-09,
         1.36411470e-12, 3.61508056e+03, -1.03925458e-01),
        (3.09288767e+00, 5.48429716e-04, 1.26505228e-07, -8.79461556e-11,
         1.17412376e-14, 3.85865700e+03, 4.47669610e+00)),
    'H2O': (1000.0,
        (4.19864056e+00, -2.03643410e-03, 6.52040211e-06, -5.48797062e-09,
         1.77197817e-12, -3.02937267e+04, -8.49032208e-01),
        (3.03399249e+00, 2.17691804e-03, -1.64072518e-07, -9.70419870e-11,
         1.68200992e-14, -3.00042971e+04, 4.96677010e+00)),
    'CH4': (1000.0,
        (5.14987613e+00, -1.36709788e-02, 4.91800599e-05, -4.84743026e-08,
         1.66693956e-11, -1.02466476e+04, -4.64130376e+00),
        (7.48514950e-02, 1.33909467e-02, -5.73285809e-06, 1.22292535e-09,
         -1.01815230e-13, -9.46834459e+03, 1.84373180e+01)),
    'CH3': (1000.0,
        (3.67359040e+00, 2.01095175e-03, 5.73021856e-06, -6.87117425e-09,
         2.54385734e-12, 1.64449988e+04, 1.60456433e+00),
        (2.28571772e+00, 7.23990037e-03, -2.98714348e-06, 5.95684644e-10,
         -4.67154394e-14, 1.67755843e+04, 8.48007179e+00)),
    'CO': (1000.0,
        (3.57953347e+00, -6.10353680e-04, 1.01681433e-06, 9.07005884e-10,
         -9.04424499e-13, -1.43440860e+04, 3.50840928e+00),
        (2.71518561e+00, 2.06252743e-03, -9.98825771e-07, 2.30053008e-10,
         -2.03647716e-14, -1.41518724e+04, 7.81868772e+00)),
    'CO2': (1000.0,
        (2.35677352e+00, 8.98459677e-03, -7.12356269e-06, 2.45919022e-09,
         -1.43699548e-13, -4.83719697e+04, 9.90105222e+00),
        (3.85746029e+00, 4.41437026e-03, -2.21481404e-06, 5.23490188e-10,
         -4.72084164e-14, -4.87591660e+04, 2.27163806e+00)),
    'C2H2': (1000.0,
        (8.08681094e-01, 2.33615629e-02, -3.55171815e-05, 2.80152437e-08,
         -8.50072974e-12, 2.64289807e+04, 1.39397051e+01),
        (4.14756964e+00, 5.96166664e-03, -2.37294852e-06, 4.67412171e-10,
         -3.61235213e-14, 2.59359992e+04, -1.23028121e+00)),
    'C2H4': (1000.0,
        (3.95920148e+00, -7.57052247e-03, 5.70990292e-05, -6.91588753e-08,
         2.69884373e-11, 5.08977593e+03, 4.09733096e+00),
        (2.03611116e+00, 1.46454151e-02, -6.71077915e-06, 1.47222923e-09,
         -1.25706061e-13, 4.93988614e+03, 1.03053693e+01)),
    'C2H6': (1000.0,
        (4.29142492e+00, -5.50154270e-03, 5.99438288e-05, -7.08466285e-08,
         2.68685771e-11, -1.15222055e+04, 2.66682316e+00),
        (1.07188150e+00, 2.16852677e-02, -1.00256067e-05, 2.21412001e-09,
         -1.90002890e-13, -1.14263932e+04, 1.51156107e+01)),
    'N2': (1000.0,
        (3.29867700e+00, 1.40824040e-03, -3.96322200e-06, 5.64151500e-09,
         -2.44485400e-12, -1.02089990e+03, 3.95037200e+00),
        (2.92664000e+00, 1.48797680e-03, -5.68476000e-07, 1.00970380e-10,
         -6.75335100e-15, -9.22797700e+02, 5.98052800e+00)),
    'NH3': (1000.0,
        (4.28602740e+00, -4.66052300e-03, 2.17185130e-05, -2.28088870e-08,
         8.26380460e-12, -6.74172850e+03, -6.25372770e-01),
        (2.63445210e+00, 5.66625600e-03, -1.72786760e-06, 2.38671610e-10,
         -1.25787860e-14, -6.54469580e+03, 6.56629280e+00)),
    'NO': (1000.0,
        (4.21847630e+00, -4.63897600e-03, 1.10410220e-05, -9.33613540e-09,
         2.80357700e-12, 9.84462300e+03, 2.28084640e+00),
        (3.26060560e+00, 1.19110430e-03, -4.29170480e-07, 6.94576690e-11,
         -4.03360990e-15, 9.92097460e+03, 6.36930270e+00)),
    'CN': (1000.0,
        (3.61293510e+00, -9.55513270e-04, 2.14429770e-06, -3.15163230e-10,
         -4.64303560e-13, 5.17083400e+04, 3.98049950e+00),
        (3.74598050e+00, 4.34507750e-05, 2.97059840e-07, -6.86518060e-11,
         4.41341730e-15, 5.15361880e+04, 2.78676010e+00)),
    'HCN': (1000.0,
        (2.25898860e+00, 1.00511700e-02, -1.33517630e-05, 1.00923490e-08,
         -3.00890280e-12, 1.47126330e+04, 8.91644190e+00),
        (3.80223920e+00, 3.14642280e-03, -1.06321850e-06, 1.66197570e-10,
         -9.79975700e-15, 1.44072920e+04, 1.57546010e+00)),
    'NH2': (1000.0,
        (4.20400290e+00, -2.10613850e-03, 7.10683480e-06, -5.61151970e-09,
         1.64407170e-12, 2.18859100e+04, -1.41842480e-01),
        (2.83474210e+00, 3.20730820e-03, -9.33908040e-07, 1.37029530e-10,
         -7.92061440e-15, 2.21719570e+04, 6.52041630e+00)),
    'NH': (1000.0,
        (3.49290850e+00, 3.11791980e-04, -1.48904840e-06, 2.48164420e-09,
         -1.03569670e-12, 4.18806290e+04, 1.84832780e+00),
        (2.78369280e+00, 1.32984290e-03, -4.24780470e-07, 7.83485010e-11,
         -5.50444700e-15, 4.21204850e+04, 5.74077990e+00)),
}

# ---------------------------------------------------------------------
# Statistical-mechanics data
# Atoms: name -> (DfH298 [kJ/mol], ((E_i [cm-1], g_i), ...))
# NIST ASD levels (grouped fine structure); truncated where the
# Boltzmann factor is negligible below 6000 K.

_ATOMS = {
    'H':  (217.998, ((0.0, 2),)),
    'He': (0.0, ((0.0, 1),)),
    'C':  (716.68, ((0.0, 1), (16.42, 3), (43.41, 5),
                    (10192.66, 5), (21648.02, 1))),
    'N':  (472.68, ((0.0, 4), (19224.46, 6), (19233.18, 4),
                    (28838.92, 6))),
    'O':  (249.18, ((0.0, 5), (158.265, 3), (226.977, 1),
                    (15867.86, 5), (33792.58, 1))),
    'Na': (107.5, ((0.0, 2), (16956.17, 2), (16973.37, 4),
                   (25739.99, 2), (29172.89, 10), (30270.0, 6))),
    'K':  (89.0, ((0.0, 2), (12985.19, 2), (13042.90, 4),
                  (21026.55, 2), (21534.68, 10), (24701.4, 6))),
    'S':  (277.17, ((0.0, 5), (396.06, 3), (573.64, 1),
                    (9238.61, 5), (22179.95, 1))),
    'Si': (450.0, ((0.0, 1), (77.11, 3), (223.16, 5),
                   (6298.85, 5), (15394.37, 1))),
    'Ti': (473.0, ((0.0, 5), (170.13, 7), (386.87, 9),
                   (6556.83, 5), (6598.75, 7), (6661.00, 9),
                   (6742.76, 11), (6842.96, 13), (8436.62, 9),
                   (11531.76, 15))),
    'V':  (514.2, ((0.0, 4), (137.38, 6), (323.46, 8), (552.96, 10),
                   (2112.28, 2), (2153.21, 4), (2220.11, 6),
                   (2311.36, 8), (2424.78, 10), (8413.0, 12))),
    'Fe': (416.3, ((0.0, 9), (415.93, 7), (704.00, 5), (888.13, 3),
                   (978.07, 1), (6928.27, 11), (7376.76, 9),
                   (7728.06, 7), (7985.78, 5), (8154.71, 3),
                   (11976.24, 9), (12560.93, 7), (12968.55, 5))),
    # Metals / P / Cl (NIST ASD levels; JANAF/CODATA DfH298):
    'Mg': (147.10, ((0.0, 1), (21850.405, 1), (21870.464, 3),
                    (21911.178, 5), (35051.264, 3))),
    'Ca': (177.80, ((0.0, 1), (15157.901, 1), (15210.063, 3),
                    (15315.943, 5), (21849.634, 5), (23652.304, 3))),
    'Al': (330.00, ((0.0, 2), (112.061, 4), (25347.756, 2),
                    (32435.45, 10))),
    'Cr': (397.48, ((0.0, 7), (7593.16, 5), (7750.78, 1),
                    (7810.82, 3), (7927.47, 5), (8095.21, 7),
                    (8307.57, 9))),
    'Mn': (283.30, ((0.0, 6), (17052.29, 10), (17282.00, 8),
                    (17451.52, 6), (17568.48, 4), (17637.15, 2),
                    (18402.46, 6), (18531.64, 8), (18705.37, 10))),
    'Ni': (430.10, ((0.0, 9), (204.787, 7), (879.816, 5),
                    (1332.164, 7), (1713.087, 3), (2216.55, 5),
                    (3409.94, 5))),
    'P':  (316.50, ((0.0, 4), (11361.02, 4), (11376.63, 6),
                    (18722.71, 2), (18748.01, 4))),
    'Cl': (121.30, ((0.0, 4), (882.352, 2))),
    # Ions (electron convention; DfH298 = neutral + IE0K + 6.197 kJ/mol,
    # JANAF values):
    'e-':  (0.0, ((0.0, 2),)),
    'H+':  (1536.25, ((0.0, 1),)),
    'H-':  (139.03, ((0.0, 1),)),
    'Na+': (609.36, ((0.0, 1),)),
    'K+':  (514.26, ((0.0, 1),)),
}

# Diatomics (RRHO):
# name -> (DfH298 [kJ/mol], we [cm-1], Be [cm-1], sigma,
#          ((E_elec [cm-1], g), ...))
_DIATOMICS = {
    'TiO': (54.4, 1009.18, 0.53541, 1,
            ((0.0, 2), (97.0, 2), (195.0, 2),      # X3Delta_1,2,3
             (3446.0, 2), (5658.0, 1),             # a1Delta, d1Sigma+
             (11838.0, 6), (14095.0, 6))),         # E3Pi, A3Phi
    'VO':  (148.9, 1011.3, 0.5468, 1,
            ((0.0, 4), (9499.0, 8), (12606.0, 8), (17420.0, 4))),
    'SiO': (-100.4, 1241.54, 0.72675, 1, ((0.0, 1),)),
    'SH':  (142.9, 2696.2, 9.4611, 1, ((0.0, 2), (377.0, 2))),
    # Huber & Herzberg (1979) constants; JANAF DfH298 unless noted:
    'HCl': (-92.31, 2990.946, 10.5934, 1, ((0.0, 1),)),
    'Cl2': (0.0, 559.75, 0.24415, 2, ((0.0, 1),)),
    'NaCl': (-181.42, 364.68, 0.218063, 1, ((0.0, 1),)),
    'KCl': (-214.57, 279.80, 0.128635, 1, ((0.0, 1),)),
    'MgH': (229.79, 1495.20, 5.8257, 1, ((0.0, 2),)),
    'CaH': (230.0, 1298.34, 4.2766, 1, ((0.0, 2),)),   # D0 ~1.70 eV
    'AlH': (259.2, 1682.56, 6.3907, 1, ((0.0, 1),)),
    'AlO': (66.94, 979.23, 0.64136, 1, ((0.0, 2),)),
    'SiH': (376.66, 2041.80, 7.4996, 1, ((0.0, 2), (142.8, 2))),
    'SiS': (112.5, 749.64, 0.30353, 1, ((0.0, 1),)),
    'CS': (280.33, 1285.15, 0.82004, 1, ((0.0, 1),)),
    'SO': (5.01, 1149.20, 0.72082, 1, ((0.0, 3),)),
    'PO': (-27.5, 1233.34, 0.73264, 1, ((0.0, 2), (224.0, 2))),
    'P2': (144.0, 780.77, 0.30362, 2, ((0.0, 1),)),
    # FeH/CrH/FeO DfH298 from D0 (Dulick 2003; Burcat); +-10 kJ/mol:
    'FeH': (460.0, 1826.86, 6.499, 1, ((0.0, 8),)),
    'CrH': (427.0, 1581.0, 6.132, 1, ((0.0, 6),)),
    'FeO': (251.04, 880.0, 0.519, 1, ((0.0, 10),)),
}

# Linear polyatomics (RRHO):
# name -> (DfH298, B [cm-1], (modes...; bends listed twice) [cm-1],
#          sigma, g_elec)
_LINEAR = {
    'OCS': (-138.41, 0.202857, (858.97, 520.4, 520.4, 2062.2), 1, 1),
    'CS2': (116.94, 0.109100, (658.0, 397.0, 397.0, 1535.35), 2, 1),
}

# Nonlinear polyatomics (RRHO):
# name -> (DfH298, (A, B, C) [cm-1], (modes...) [cm-1], sigma, g_elec)
_POLYATOMICS = {
    'H2S': (-20.5, (10.360, 8.991, 6.611), (1182.6, 2614.4, 2628.5), 2, 1),
    'SO2': (-296.8, (2.0274, 0.34417, 0.29353),
            (1151.4, 517.7, 1361.8), 2, 1),
    'PH3': (5.47, (4.4537, 4.4537, 3.919),
            (2323.0, 992.0, 2328.0, 2328.0, 1118.0, 1118.0), 3, 1),
    'SO3': (-395.77, (0.34854, 0.34854, 0.17427),
            (1064.9, 497.5, 1391.5, 1391.5, 530.2, 530.2), 6, 1),
    'SiH4': (34.31, (2.859, 2.859, 2.859),
             (2186.9, 974.6, 974.6, 2189.2, 2189.2, 2189.2,
              913.5, 913.5, 913.5), 12, 1),
    # TiO2 gas (JANAF DfH298; bent C2v, computed rotational constants
    # and matrix-isolation fundamentals; S298 uncertainty ~2 J/mol/K):
    'TiO2': (-305.43, (1.085, 0.2983, 0.2309),
             (946.9, 330.0, 917.1), 2, 1),
}

# GRI-Mech shipped older formation enthalpies for a few species; pin
# them to the JANAF/ATcT values by shifting a6 in both ranges (leaves
# Cp and S untouched):
_DFH_PIN = {'HCN': 135.1, 'NH2': 186.2}  # kJ/mol

# Formation-enthalpy provenance and uncertainty for the metal
# hydrides/oxides with no chemcat golden to calibrate against
# (tests/test_chem.py quantifies the equilibrium-VMR impact).  DfH298
# in kJ/mol; uncertainties are the spread of the cited determinations
# (dissociation energies via Barklem & Collet 2016, A&A 588, A96;
# JANAF 4th ed. for TiO2; Burcat/ATcT where listed).  A +-u enthalpy
# error maps onto trace VMRs as roughly exp(u / RT): at 2000 K,
# +-10 kJ/mol is a factor ~1.8 in the retrieved abundance -- callers
# doing FeH/CrH/CaH/TiO2 abundance science should treat equilibrium
# priors on these species accordingly.
THERMO_UNCERTAINTY = {
    # species: (DfH298 used [kJ/mol], +-unc [kJ/mol], source)
    'FeH': (460.0, 10.0,
            'D0 = 1.59 eV (Dulick et al. 2003; Barklem & Collet 2016)'
            ' + JANAF Fe(g), H(g)'),
    'CrH': (427.0, 10.0,
            'D0 = 2.0 eV class determinations (Burcat; Barklem &'
            ' Collet 2016) + JANAF Cr(g), H(g)'),
    'CaH': (230.0, 8.0,
            'D0 = 1.70 eV (Huber & Herzberg 1979; Barklem & Collet'
            ' 2016) + JANAF Ca(g), H(g)'),
    'TiO2': (-305.43, 12.0,
             'JANAF 4th ed. (matrix-isolation fundamentals; S298'
             ' unc. ~2 J/mol/K)'),
    'FeO': (251.04, 8.0, 'JANAF 4th ed. / Burcat'),
    'MgH': (229.79, 6.0, 'JANAF 4th ed.'),
}


def _apply_dfh_pins():
    for name, dfh in _DFH_PIN.items():
        tmid, low, high = _NASA7[name]
        h298, _ = _nasa7_h_s(low, np.array([_T_REF]))
        shift = dfh * 1000.0 / _R_GAS - h298[0] * _T_REF
        low = low[:5] + (low[5] + shift, low[6])
        high = high[:5] + (high[5] + shift, high[6])
        _NASA7[name] = (tmid, low, high)


_CHARGE_RE = re.compile(r'([+-])$')
_FORMULA_RE = re.compile(r'([A-Z][a-z]?)(\d*)')


def parse_formula(name):
    """Split a species name into ({element: count}, charge)."""
    if name == 'e-':
        return {}, -1
    charge = 0
    m = _CHARGE_RE.search(name)
    body = name
    if m:
        charge = 1 if m.group(1) == '+' else -1
        body = name[:-1]
    stoich = {}
    pos = 0
    for m in _FORMULA_RE.finditer(body):
        if m.start() != pos:
            raise ValueError(f'Cannot parse species formula {name!r}')
        pos = m.end()
        elem = m.group(1)
        if elem not in ELEMENT_MASS:
            raise ValueError(f'Unknown element {elem!r} in {name!r}')
        stoich[elem] = stoich.get(elem, 0) + int(m.group(2) or 1)
    if pos != len(body):
        raise ValueError(f'Cannot parse species formula {name!r}')
    return stoich, charge


def species_mass(name):
    """Molecular mass in amu (electron-mass corrected for ions)."""
    stoich, charge = parse_formula(name)
    mass = sum(ELEMENT_MASS[el] * n for el, n in stoich.items())
    return mass - charge * _E_MASS


def has_thermo(name):
    return (
        name in _NASA7 or name in _ATOMS or name in _DIATOMICS
        or name in _POLYATOMICS or name in _LINEAR
    )


def supported_species():
    return sorted(
        set(_NASA7) | set(_ATOMS) | set(_DIATOMICS)
        | set(_POLYATOMICS) | set(_LINEAR)
    )


# ---------------------------------------------------------------------
# Thermodynamic functions (host side, float64 numpy)

# NASA-7/GRI-Mech coefficients are referenced to 1 atm; the network's
# standard state is 1 bar (_P_STD), so shift the entropy constant a7 by
# R ln(101325/1e5) to convert: S(1 bar) = S(1 atm) + R ln(1.01325).
_S_ATM_TO_BAR = np.log(101325.0 / 1.0e5)


def _nasa7_h_s(coefs, temp):
    """(H/RT, S/R) from one NASA-7 coefficient row, entropy converted
    to the 1 bar standard state."""
    a1, a2, a3, a4, a5, a6, a7 = coefs
    t = temp
    h = (a1 + a2 * t / 2 + a3 * t**2 / 3 + a4 * t**3 / 4
         + a5 * t**4 / 5 + a6 / t)
    s = (a1 * np.log(t) + a2 * t + a3 * t**2 / 2 + a4 * t**3 / 3
         + a5 * t**4 / 4 + a7 + _S_ATM_TO_BAR)
    return h, s


_apply_dfh_pins()


def _nasa7_thermo(name, temp):
    """(H(T)/RT, S(T)/R) with H referenced to DfH298 (built into a6).

    Clipped below 200 K (the NASA-7 validity floor); _T_GRID starts at
    200 K so statmech species are clipped at the same bound and cold
    layers stay mutually consistent."""
    tmid, low, high = _NASA7[name]
    tc = np.clip(temp, 200.0, None)
    h_lo, s_lo = _nasa7_h_s(low, tc)
    h_hi, s_hi = _nasa7_h_s(high, tc)
    hot = tc >= tmid
    return np.where(hot, h_hi, h_lo), np.where(hot, s_hi, s_lo)


def _trans_entropy(mass_amu, temp):
    """Sackur-Tetrode S_trans/R at the standard pressure."""
    m = mass_amu * _AMU
    lam = (2 * np.pi * m * _K_BOLTZ * temp) / _H_PLANCK**2
    return 1.5 * np.log(lam) + np.log(_K_BOLTZ * temp / _P_STD) + 2.5


def _elec_parts(levels, temp):
    """(E_int/RT, S_int/R) for a set of (E_cm, g) levels."""
    e = np.array([_C2_CM * lev for lev, g in levels])    # K
    g = np.array([float(g) for lev, g in levels])
    x = e[:, None] / temp[None, :]
    w = g[:, None] * np.exp(-x)
    q = np.sum(w, axis=0)
    e_rt = np.sum(w * x, axis=0) / q
    return e_rt, np.log(q) + e_rt


def _vib_parts(omega_cm, temp):
    """(E/RT, S/R) of one harmonic mode (zero-point at the minimum
    excluded; it is absorbed into DfH298)."""
    x = _C2_CM * omega_cm / temp
    ex = np.expm1(x)
    e_rt = x / ex
    s = e_rt - np.log(-np.expm1(-x))
    return e_rt, s


def _statmech_thermo(name, temp):
    """(H(T)/RT, S(T)/R) for a statistical-mechanics species, with H
    referenced so that H(298.15) = DfH298."""
    temp = np.asarray(temp, float)

    def thermal(t):
        # returns (E_thermal/RT  [H = E + RT], S/R)
        if name in _ATOMS:
            dfh, levels = _ATOMS[name]
            e_rt, s_int = _elec_parts(levels, t)
            s = _trans_entropy(species_mass(name), t) + s_int
            return 1.5 + e_rt, s
        if name in _DIATOMICS:
            dfh, we, be, sigma, levels = _DIATOMICS[name]
            e_el, s_el = _elec_parts(levels, t)
            e_vib, s_vib = _vib_parts(we, t)
            q_rot = t / (sigma * _C2_CM * be)
            e_rt = 1.5 + 1.0 + e_vib + e_el
            s = (_trans_entropy(species_mass(name), t)
                 + np.log(q_rot) + 1.0 + s_vib + s_el)
            return e_rt, s
        if name in _LINEAR:
            dfh, be, modes, sigma, g_el = _LINEAR[name]
            q_rot = t / (sigma * _C2_CM * be)
            e_vib = np.zeros_like(t)
            s_vib = np.zeros_like(t)
            for mode in modes:
                ev, sv = _vib_parts(mode, t)
                e_vib += ev
                s_vib += sv
            e_rt = 1.5 + 1.0 + e_vib
            s = (_trans_entropy(species_mass(name), t)
                 + np.log(q_rot) + 1.0 + s_vib + np.log(g_el))
            return e_rt, s
        dfh, rots, modes, sigma, g_el = _POLYATOMICS[name]
        ta, tb, tc_ = (_C2_CM * r for r in rots)
        q_rot = np.sqrt(np.pi * t**3 / (ta * tb * tc_)) / sigma
        e_vib = np.zeros_like(t)
        s_vib = np.zeros_like(t)
        for mode in modes:
            ev, sv = _vib_parts(mode, t)
            e_vib += ev
            s_vib += sv
        e_rt = 1.5 + 1.5 + e_vib
        s = (_trans_entropy(species_mass(name), t)
             + np.log(q_rot) + 1.5 + s_vib + np.log(g_el))
        return e_rt, s

    if name in _ATOMS:
        dfh = _ATOMS[name][0]
    elif name in _DIATOMICS:
        dfh = _DIATOMICS[name][0]
    elif name in _LINEAR:
        dfh = _LINEAR[name][0]
    else:
        dfh = _POLYATOMICS[name][0]

    e_rt, s = thermal(temp)
    e_ref, _ = thermal(np.array([_T_REF]))
    # H(T) = DfH298 + [E(T) + RT] - [E(298) + R 298]:
    h_over_rt = (
        (dfh * 1000.0 / _R_GAS
         + (1.0 + e_rt) * temp - (1.0 + e_ref[0]) * _T_REF) / temp
    )
    return h_over_rt, s


def thermo_properties(name, temp):
    """(H/RT, S/R) of a species at temperature(s) [K]; standard state
    is the ideal gas at 1 bar, enthalpy referenced to the elements in
    their standard states at 298.15 K."""
    temp = np.atleast_1d(np.asarray(temp, float))
    if name in _NASA7:
        return _nasa7_thermo(name, temp)
    if has_thermo(name):
        return _statmech_thermo(name, temp)
    raise ValueError(f'No thermodynamic data for species {name!r}')


# g0-level calibration to the NASA-9 Glenn database as used by the
# reference's chemcat: the GRI-Mech NASA-7 fits differ from chemcat's
# thermo by small, smooth offsets that bias hot-Jupiter trace VMRs by
# up to ~4%.  The corrections g0 += ds + dh/T (ds: entropy-like, R
# units; dh: enthalpy-like, K) were fitted against the reference's
# SOLAR chemcat golden (tests/expected/expected_tea_profile.npz) and
# validated against the held-out SUB-SOLAR golden
# (expected_tea_sub_solar_profile.npz) -- see
# tests/test_chem.py::test_tea_profile_vs_chemcat_golden.
# thermo_properties() (Cp/H/S literature pins) is untouched.
# Held-out result: every trace species <= 0.8% of chemcat across both
# metallicities (was up to ~4% uncalibrated).
#
# FITTED VALIDITY RANGE: the goldens are guillot hot-Jupiter profiles
# (T ~ 700-1500 K) at [M/H] = 0 and -1; the ds + dh/T form is the
# leading-order expansion of a NASA-polynomial difference, so it
# extrapolates smoothly, but outside roughly T in [500, 3000] K the
# corrections are unvalidated (they stay small: |ds| <= 0.12 R,
# |dh| <= 160 K, i.e. <= ~0.2 kT at 1000 K).  Disable with
# PBT_CHEM_CAL=0 (env, read at import) or chem.CALIBRATE_G0 = False
# to get the uncorrected GRI-Mech/statmech thermodynamics.
CALIBRATE_G0 = os.environ.get('PBT_CHEM_CAL', '1') != '0'
_G0_CALIBRATION = {
    'Na': (+0.000071, +0.0644),
    'K': (+0.001103, +1.1805),
    'H2O': (+0.008592, -9.2683),
    'CH4': (+0.117608, -157.0182),
    'CO': (-0.022514, +24.2737),
    'CO2': (-0.017386, +16.9667),
    'NH3': (-0.015258, +3.8269),
    'HCN': (-0.043305, +37.5078),
    'N2': (+0.001501, -1.6140),
}


def gibbs_over_rt(name, temp):
    """g0 = G/(RT) = H/RT - S/R at the 1 bar standard state (with the
    _G0_CALIBRATION chemcat-parity offsets applied unless
    CALIBRATE_G0 is False)."""
    h, s = thermo_properties(name, temp)
    g0 = h - s
    cal = _G0_CALIBRATION.get(name) if CALIBRATE_G0 else None
    if cal is not None:
        ds, dh = cal
        g0 = g0 + ds + dh / np.atleast_1d(np.asarray(temp, float))
    return g0



# ---------------------------------------------------------------------
# Equilibrium solver (torch, batched over leading axes, float64)

# Starts at the NASA-7 clip floor (200 K) so all species -- polynomial
# and statmech alike -- freeze at the same temperature bound:
_T_GRID = np.arange(200.0, 6001.0, 2.0)

_N_AVG = 32    # averaged tail steps


def _newton_step(ln_n, ln_ntot, mu0, b, btot, stoich, stoich2, eye):
    """One damped Gibbs-descent Newton step of every system: ln_n
    [..., ns], ln_ntot [...]; mu0 = g0 + ln p [..., ns]; b [..., ne];
    btot [...]; stoich [ns, ne]; stoich2 [ns, ne * ne] the products
    stoich[i, j] stoich[i, k] of the Newton matrix
    sum_i stoich[i, j] stoich[i, k] n_i."""
    ne = stoich.shape[1]
    n = torch.exp(ln_n)
    nsum = torch.sum(n, dim=-1)
    ntot = torch.exp(ln_ntot)
    mu = mu0 + ln_n - ln_ntot[..., None]

    a_mat = torch.matmul(n, stoich2).reshape(*n.shape[:-1], ne, ne)
    bhat = torch.matmul(n, stoich)
    rhs_el = b - bhat + torch.matmul(n * mu, stoich)
    rhs_n = ntot - nsum + torch.sum(n * mu, dim=-1)

    mat = torch.cat([
        torch.cat([a_mat, bhat[..., :, None]], dim=-1),
        torch.cat([bhat, (nsum - ntot)[..., None]], dim=-1)[..., None, :],
    ], dim=-2)
    diag = torch.diagonal(mat, dim1=-2, dim2=-1)
    reg = 1e-12 * (torch.sum(diag, dim=-1) / (ne + 1) + btot)
    mat = mat + reg[..., None, None] * eye
    # Symmetric diagonal (Jacobi) scaling: element moles span ~7 decades
    # (H at 1 against K at 1e-7).
    scale = 1.0 / torch.sqrt(
        torch.abs(torch.diagonal(mat, dim1=-2, dim2=-1)) + 1e-30)
    mat_s = mat * scale[..., :, None] * scale[..., None, :]
    rhs_s = torch.cat([rhs_el, rhs_n[..., None]], dim=-1) * scale
    sol = torch.linalg.solve_ex(mat_s, rhs_s[..., None])[0][..., 0] * scale

    pi = sol[..., :ne]
    dln_ntot = sol[..., ne]
    dln_n = dln_ntot[..., None] + torch.matmul(pi, stoich.T) - mu
    step = torch.maximum(
        torch.amax(torch.abs(dln_n), dim=-1), torch.abs(dln_ntot))
    lam = torch.clamp(2.0 / torch.clamp(step, min=1e-12), max=1.0)
    ln_ntot_new = ln_ntot + lam * dln_ntot
    ln_n_new = torch.clamp(
        ln_n + lam[..., None] * dln_n,
        min=(ln_ntot_new - 70.0)[..., None],
        max=(ln_ntot_new + 2.0)[..., None])
    return ln_n_new, ln_ntot_new


def equilibrium_vmr(g0, lnp, b, stoich, n_iter=120):
    """Equilibrium VMRs of a batch of layers (pyratbay_tpu chem.py
    equilibrium_vmr, over any leading axes).

    g0 [..., ns] standard-state G/RT; lnp [...] ln(P / 1 bar); b
    [..., ne] element (and charge) moles; stoich [ns, ne]; n_iter
    damped Newton steps before the 32 averaged ones.  All are
    taken to float64 on g0's device.  Returns vmr [..., ns], float64.
    On a CUDA device the solve is one launch (equilibrium_cuda).
    """
    f64 = torch.float64
    dev = g0.device
    g0 = g0.to(f64)
    lnp = torch.as_tensor(lnp, device=dev).to(f64)
    b = torch.as_tensor(b, device=dev).to(f64)
    stoich = torch.as_tensor(stoich, device=dev).to(f64)
    ns, ne = stoich.shape
    if g0.is_cuda:
        lead = g0.shape[:-1]
        vmr = equilibrium_cuda(
            stoich, lnp.expand(lead).reshape(-1), n_iter=n_iter,
            g0=g0.reshape(-1, ns), b=b.expand(*lead, ne).reshape(-1, ne))
        return vmr.reshape(g0.shape)
    btot = torch.sum(torch.abs(b), dim=-1) + 1e-30
    mu0 = g0 + lnp[..., None]
    eye = torch.eye(ne + 1, dtype=f64, device=dev)
    stoich2 = (stoich[:, :, None] * stoich[:, None, :]).reshape(ns, ne * ne)
    consts = (mu0, b, btot, stoich, stoich2, eye)

    ln_n = torch.log(0.1 * btot / ns)[..., None].expand(g0.shape)
    ln_ntot = torch.log(0.6 * btot)
    for _ in range(n_iter):
        ln_n, ln_ntot = _newton_step(ln_n, ln_ntot, *consts)
    # Averaged tail (the reference's float32 damping, kept for parity):
    acc = torch.zeros_like(ln_n)
    for _ in range(_N_AVG):
        ln_n, ln_ntot = _newton_step(ln_n, ln_ntot, *consts)
        acc = acc + ln_n
    n = torch.exp(acc / _N_AVG)
    return n / torch.sum(n, dim=-1, keepdim=True)


# The largest network the solve kernel takes (csrc/chem_gibbs.cu): species,
# element columns (the elements and the charge column), element ratios.
CHEM_MAX_SPECIES = 24
CHEM_MAX_COLS = 15
CHEM_MAX_RATIOS = 4


def check_kernel_size(ns, ncols, nratios=0):
    """Raise ValueError unless the solve kernel takes a network of `ns`
    species and `ncols` element columns, and `nratios` element ratios."""
    if ns > CHEM_MAX_SPECIES or ncols > CHEM_MAX_COLS:
        raise ValueError(
            f'The equilibrium kernel takes at most CHEM_MAX_SPECIES = '
            f'{CHEM_MAX_SPECIES} species and CHEM_MAX_COLS = '
            f'{CHEM_MAX_COLS} element columns; this network has {ns} and '
            f'{ncols}')
    if nratios > CHEM_MAX_RATIOS:
        raise ValueError(
            f'The equilibrium kernel takes at most CHEM_MAX_RATIOS = '
            f'{CHEM_MAX_RATIOS} element ratios, not {nratios}')


@functools.lru_cache(maxsize=1)
def _kernel_library():
    from ..spectrum.transit_kernel import _library
    lib = _library()
    ptr, cint, cdouble = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    lib.pbt_chem_gibbs.argtypes = (
        [cint] * 6 + [ptr] * 5 + [cint] + [ptr, cint, cdouble, cdouble]
        + [ptr] * 4 + [cint, ptr, ptr, ptr] + [cint, ptr, ptr])
    lib.pbt_chem_gibbs.restype = cint
    return lib


def _f64(t, shape, name, device):
    """t as the kernel reads it: a contiguous float64 tensor of `shape` on
    `device`."""
    t = t.to(torch.float64).contiguous()
    if tuple(t.shape) != tuple(shape) or t.device != device:
        raise ValueError(f'{name}: {tuple(t.shape)} on {t.device}, '
                         f'expected {shape} on {device}')
    return t


def equilibrium_cuda(stoich, lnp, n_iter=120, g0=None, b=None, temp=None,
                     table=None, budget=None):
    """The equilibrium solve of every system in one launch of the kernel
    (csrc/chem_gibbs.cu), float64, on stoich's CUDA device; the same
    arithmetic as equilibrium_vmr's torch steps.  Returns vmr [S, ns].

    Either g0 [S, ns], lnp [S] and b [S, ncols] given per system, or
    temp [B, l] (float32 or float64) with lnp [l], table = (g_table [nT,
    ns], t0, dt) (G/RT lerped at the temperature clamped to the grid) and
    budget = (solar_dex [ne], is_metal [ne], metallicity [B] or None,
    escale [B, ne] or None, ratios ((i_num, i_den, value [B]), ...)), as
    equilibrium_fn builds the element moles.  Each launch adds one to
    `equilibrium_cuda.launches`."""
    if not stoich.is_cuda:
        raise TypeError('equilibrium_cuda: expected CUDA tensors')
    dev = stoich.device
    stoich = _f64(stoich, stoich.shape, 'stoich', dev)
    ns, ncols = stoich.shape
    g_table = solar = metal = metallicity = escale = None
    ne, nlayers, temp_f32, ntemp, t0, dt, ratios = ncols, 1, 0, 2, 0.0, 1.0, []
    if temp is None:
        nsys = g0.shape[0]
        g0 = _f64(g0, (nsys, ns), 'g0', dev)
        b = _f64(b, (nsys, ncols), 'b', dev)
        lnp = _f64(lnp, (nsys,), 'lnp', dev)
    else:
        nb, nlayers = temp.shape
        nsys = nb * nlayers
        if temp.dtype != torch.float32:
            temp = _f64(temp, (nb, nlayers), 'temp', dev)
        temp = temp.contiguous()
        temp_f32 = int(temp.dtype == torch.float32)
        g_table, t0, dt = table
        solar, metal, metallicity, escale, ratios = budget
        ne = solar.shape[0]
        g_table = _f64(g_table, (g_table.shape[0], ns), 'g_table', dev)
        ntemp = g_table.shape[0]
        solar = _f64(solar, (ne,), 'solar_dex', dev)
        metal = _f64(metal, (ne,), 'is_metal', dev)
        lnp = _f64(lnp, (nlayers,), 'lnp', dev)
        if metallicity is not None:
            metallicity = _f64(metallicity, (nb,), 'metallicity', dev)
        if escale is not None:
            escale = _f64(escale, (nb, ne), 'escale', dev)
        ratios = [(int(i), int(j), _f64(v, (nb,), 'ratio', dev))
                  for i, j, v in ratios]
    check_kernel_size(ns, ncols, len(ratios))
    ptr = lambda t: None if t is None else t.data_ptr()
    nums = (ctypes.c_int * CHEM_MAX_RATIOS)(*[r[0] for r in ratios])
    dens = (ctypes.c_int * CHEM_MAX_RATIOS)(*[r[1] for r in ratios])
    vals = (ctypes.c_void_p * CHEM_MAX_RATIOS)(
        *[r[2].data_ptr() for r in ratios])
    vmr = torch.empty((nsys, ns), dtype=torch.float64, device=dev)
    err = _kernel_library().pbt_chem_gibbs(
        int(temp is not None), nsys, nlayers, ns, ncols, ne, ptr(stoich),
        ptr(g0), ptr(b), ptr(lnp), ptr(temp), temp_f32, ptr(g_table),
        ntemp, float(t0), float(dt), ptr(solar), ptr(metal),
        ptr(metallicity), ptr(escale), len(ratios), nums, dens, vals,
        int(n_iter), vmr.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f'equilibrium kernel launch failed: CUDA error {err}')
    equilibrium_cuda.launches += 1
    return vmr


equilibrium_cuda.launches = 0


class Network:
    """Thermochemical-equilibrium network (pyratbay_tpu chem.Network).

    Host set-up: species without thermodynamic data are dropped, the
    stoichiometry is built over the elements present (with a charge
    column when ions are), and G/RT is tabulated on _T_GRID.
    thermochemical_equilibrium() solves the configured profile with
    equilibrium_vmr on the CPU in float64 (set-up work); the device
    evaluator of a retrieval is equilibrium_fn(network, device=...).
    """

    def __init__(self, pressure, temperature, species,
                 metallicity=0.0, e_abundances=None, e_scale=None,
                 e_ratio=None, e_source='asplund_2021'):
        self.pressure = np.asarray(pressure, float)   # bar
        self.temperature = np.asarray(temperature, float)
        if len(self.pressure) != len(self.temperature):
            raise ValueError(
                'pressure and temperature array lengths do not match'
            )
        kept, dropped = [], []
        for spec in species:
            (kept if has_thermo(spec) else dropped).append(spec)
        self.species = np.array(kept)
        self.dropped_species = dropped
        if len(kept) < 2:
            raise ValueError(
                f'Not enough species with thermodynamic data: {kept} '
                f'(no data for {dropped})'
            )

        parsed = [parse_formula(spec) for spec in kept]
        elements = sorted(
            {el for stoich, _ in parsed for el in stoich},
            key=lambda el: list(ELEMENT_MASS).index(el),
        )
        self._has_charge = any(charge != 0 for _, charge in parsed)
        self.elements = np.array(elements)
        ncols = len(elements) + int(self._has_charge)
        stoich = np.zeros((len(kept), ncols))
        for i, (st, charge) in enumerate(parsed):
            for el, count in st.items():
                stoich[i, elements.index(el)] = count
            if self._has_charge:
                stoich[i, -1] = charge
        self.stoich_vals = stoich[:, :len(elements)].astype(int)
        self._stoich_full = stoich

        if isinstance(e_source, str):
            try:
                solar = SOLAR_ABUNDANCES[e_source]
            except KeyError:
                raise ValueError(
                    f'Unknown solar-abundance source {e_source!r}; '
                    f"choose from {sorted(SOLAR_ABUNDANCES)}"
                )
        else:
            solar = dict(e_source)
        self._solar_dex = np.array([solar[el] for el in elements])
        self._is_metal = np.array(
            [el not in ('H', 'He') for el in elements],
        )

        self.metallicity = float(metallicity)
        self.e_abundances = dict(e_abundances or {})
        self.e_scale = dict(e_scale or {})
        self.e_ratio = dict(e_ratio or {})

        # Gibbs-energy grid [ns, nT] (float64, host):
        self._g_grid = np.stack([
            gibbs_over_rt(spec, _T_GRID) for spec in kept
        ])
        self.mass = np.array([species_mass(spec) for spec in kept])

        self.element_rel_abundance = self._element_b(
            self.metallicity, self.e_abundances, self.e_scale,
            self.e_ratio,
        )[:len(elements)]
        self.vmr = None

    def _element_b(self, metallicity, e_abundances, e_scale, e_ratio):
        """Element mole vector (per total H = 1), plus charge-0 column."""
        dex = self._solar_dex + self._is_metal * (metallicity or 0.0)
        for el, val in (e_abundances or {}).items():
            if el in self.elements:
                dex[list(self.elements).index(el)] = val
        for el, val in (e_scale or {}).items():
            if el in self.elements:
                dex[list(self.elements).index(el)] += val
        b = 10.0**(dex - 12.0)
        for pair, val in (e_ratio or {}).items():
            num, den = pair.split('_')
            els = list(self.elements)
            if num in els and den in els:
                b[els.index(num)] = val * b[els.index(den)]
        if self._has_charge:
            b = np.append(b, 0.0)
        return b

    def gibbs_at(self, temperature):
        """Interpolated g0 [nlayers, ns] at the layer temperatures."""
        temp = np.clip(temperature, _T_GRID[0], _T_GRID[-1])
        idx = np.clip(
            np.searchsorted(_T_GRID, temp) - 1, 0, len(_T_GRID) - 2,
        )
        w = (temp - _T_GRID[idx]) / (_T_GRID[idx + 1] - _T_GRID[idx])
        return (
            self._g_grid[:, idx] * (1 - w) + self._g_grid[:, idx + 1] * w
        ).T

    def thermochemical_equilibrium(
            self, temperature=None, metallicity=None,
            e_abundances=None, e_scale=None, e_ratio=None,
        ):
        """Solve for equilibrium VMRs [nlayers, nspecies] (numpy).

        Per-call overrides update the stored state; None keeps it, and
        a dict (also {}) replaces the stored one.
        """
        if temperature is not None:
            temperature = np.asarray(temperature, float)
            if len(temperature) != len(self.pressure):
                raise ValueError(
                    'temperature array length does not match pressure'
                )
            self.temperature = temperature
        if metallicity is not None:
            self.metallicity = float(metallicity)
        if e_abundances is not None:
            self.e_abundances = dict(e_abundances)
        if e_scale is not None:
            self.e_scale = dict(e_scale)
        if e_ratio is not None:
            self.e_ratio = dict(e_ratio)

        b = self._element_b(
            self.metallicity, self.e_abundances, self.e_scale,
            self.e_ratio,
        )
        self.element_rel_abundance = b[:len(self.elements)]
        g0 = torch.as_tensor(self.gibbs_at(self.temperature))
        lnp = np.log(self.pressure)    # ln(P / 1 bar), the standard state
        nlayers = len(self.pressure)
        vmr = equilibrium_vmr(
            g0, torch.as_tensor(lnp),
            torch.as_tensor(np.broadcast_to(b, (nlayers, len(b))).copy()),
            torch.as_tensor(self._stoich_full),
        )
        self.vmr = vmr.numpy()
        return np.copy(self.vmr)


def read_solar_file(path):
    """Read a solar elemental-abundance file (reference
    data/AsplundEtal2009.txt format: atomic number, symbol, dex
    abundance, name, mass) into a {element: dex} dict."""
    solar = {}
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line or line.startswith('#'):
                continue
            fields = line.split()
            solar[fields[1]] = float(fields[2])
    return solar


def equilibrium_fn(network, device):
    """The equilibrium evaluator of a Network on `device` (pyratbay_tpu
    chem.py jit_equilibrium_fn, batched over chains).

    Returns fn(temp [B, l], metallicity=None ([B] or None: 0),
    escale=None ([B, nelem] dex offsets or None), ratios=() (a sequence
    of (i_num, i_den, value [B]) element ratios, applied in order:
    b[num] = value * b[den])) -> vmr [B, l, ns], float64.  The element
    budget of each chain is dex = solar + is_metal * [M/H] + escale,
    b = 10^(dex - 12), with a charge column b = 0 when ions are present;
    G/RT is the lerp of the network's table at the clipped temperature.
    On a CUDA device fn is one launch of the solve kernel
    (equilibrium_cuda), which makes G/RT and b itself; a network above
    the kernel's sizes raises ValueError here.
    """
    f64 = torch.float64
    tensor = lambda a: torch.as_tensor(
        np.asarray(a, float), dtype=f64, device=device)
    lnp = tensor(np.log(network.pressure))
    g_table = tensor(network._g_grid.T)                  # [nT, ns]
    solar_dex = tensor(network._solar_dex)
    is_metal = tensor(network._is_metal)
    stoich = tensor(network._stoich_full)
    has_charge = network._has_charge
    t0 = float(_T_GRID[0])
    dt = float(_T_GRID[1] - _T_GRID[0])
    ntg = len(_T_GRID)
    if stoich.is_cuda:
        check_kernel_size(*stoich.shape)
        table = (g_table.contiguous(), t0, dt)

        def fn_cuda(temp, metallicity=None, escale=None, ratios=()):
            vmr = equilibrium_cuda(
                stoich, lnp, temp=temp, table=table, budget=(
                    solar_dex, is_metal, metallicity, escale, ratios))
            return vmr.reshape(*temp.shape, stoich.shape[0])

        return fn_cuda

    def fn(temp, metallicity=None, escale=None, ratios=()):
        temp = temp.to(f64)
        nb, nlayers = temp.shape
        dex = solar_dex.expand(nb, -1)
        if metallicity is not None:
            dex = dex + is_metal * metallicity.to(f64)[:, None]
        if escale is not None:
            dex = dex + escale.to(f64)
        b = 10.0 ** (dex - 12.0)
        if len(ratios):
            b = b.clone()
            for i_num, i_den, val in ratios:
                b[:, i_num] = val.to(f64) * b[:, i_den]
        if has_charge:
            b = torch.cat([b, torch.zeros_like(b[:, :1])], dim=1)
        tc = torch.clamp(temp, t0, t0 + dt * (ntg - 1))
        x = (tc - t0) / dt
        i0 = torch.clamp(x.to(torch.int64), 0, ntg - 2)
        w = (x - i0)[..., None]
        g0 = g_table[i0] * (1 - w) + g_table[i0 + 1] * w   # [B, l, ns]
        return equilibrium_vmr(
            g0, lnp.expand(nb, nlayers), b[:, None, :].expand(
                nb, nlayers, b.shape[1]), stoich)

    return fn


def hybrid_max_vmr(vmr, stoich_cols, mol_stoich):
    """Element-availability cap for a free VMR on top of equilibrium
    (reference vmr_models.hybrid_vmr): vmr [..., l, ns]; stoich_cols
    [ns, k] the stoichiometry columns of the molecule's elements;
    mol_stoich [k] their counts in the molecule.  Returns the largest
    VMR each layer allows [..., l]."""
    stoich_cols = torch.as_tensor(
        stoich_cols, dtype=vmr.dtype, device=vmr.device)
    mol_stoich = torch.as_tensor(
        mol_stoich, dtype=vmr.dtype, device=vmr.device)
    return torch.amin(torch.matmul(vmr, stoich_cols) / mol_stoich, dim=-1)


def chemistry(chem_model, pressure, temperature, species,
              metallicity=0.0, e_abundances=None, e_scale=None,
              e_ratio=None, q_uniform=None, solar_file=None,
              atmfile=None, punits='bar'):
    """Compute atmospheric abundances (pyratbay_tpu chem.chemistry):
    chem_model 'free' (uniform q_uniform VMRs) or 'equilibrium'.
    Returns (network, species, vmr) as numpy; writes atmfile if given."""
    if solar_file is None:
        solar_file = 'asplund_2021'
    pressure = np.asarray(pressure, float)
    temperature = np.asarray(temperature, float)
    if len(pressure) != len(temperature):
        raise ValueError(
            f'pressure ({len(pressure)}) and temperature array lengths '
            f"({len(temperature)}) don't match"
        )

    if chem_model == 'free':
        if q_uniform is None or len(species) != len(q_uniform):
            raise ValueError(
                f'Species ({len(species)}) and q_uniform array lengths '
                "don't match"
            )
        network = None
        vmr = np.tile(
            np.asarray(q_uniform, float), (len(pressure), 1),
        )
        out_species = np.array(species)
    elif chem_model == 'equilibrium':
        network = Network(
            pressure, temperature, species,
            metallicity=metallicity, e_abundances=e_abundances,
            e_scale=e_scale, e_ratio=e_ratio, e_source=solar_file,
        )
        network.thermochemical_equilibrium()
        out_species = network.species
        vmr = np.copy(network.vmr)
    else:
        raise ValueError(f'Invalid chemistry model {chem_model!r}')

    if atmfile is not None:
        from ..io import io as pio
        pio.write_atm(
            atmfile, pressure, temperature, list(out_species), vmr,
            punits=punits, header='# TEA atmospheric file\n\n',
        )
    return network, out_species, vmr
