# Data generators: the paper's §2.12 simulations, the §2.13 MEG/EEG shape, and
# the synthetic token stream of the LM training path.
