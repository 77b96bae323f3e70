# Data generators: the paper's §2.12 simulations and the §2.13 MEG/EEG shape.
