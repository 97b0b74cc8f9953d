"""Developer scripts of the port that run on the GPU machine."""
