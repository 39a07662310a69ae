"""Plain PyTorch references of the benchmark's configurations: no kernel,
no cache, no batching of the program's, and nothing imported from it."""
