"""Device compute: LD packing, CAVI sweeps (plain and CUDA), updates, EM loop."""
