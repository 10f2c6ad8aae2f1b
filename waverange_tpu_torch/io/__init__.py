"""File-format interfaces: generic raw/Fortran, FluSI HDF5, MSSG (copies
of `waverange_tpu.io` that call this package's codec on a torch device)."""
