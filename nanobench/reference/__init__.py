"""The plain reference the benchmark holds the program's outputs against.

Plain PyTorch and NumPy, written from the upstream project's semantics
(Dellintel98/smart-nanogrid-gym: the charging station, the chargers, the
BESS, the accountant and the rule-based controller) and the port's
documented draw layout (Philox4x32-10 keyed by seed and env).  It imports
nothing of the program and takes nothing the program made: its price and
solar tables come from the raw irradiance file and the published tariffs,
its weights and draws from the inputs the benchmark hands to both sides.
"""
