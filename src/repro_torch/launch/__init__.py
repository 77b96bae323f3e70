# Command-line launchers of the LLM substrate: serve (prefill + greedy decode),
# probe (analytical-CV permutation tests on layer representations) and train;
# and the mesh tooling: mesh, sharding, step_analysis, dryrun and roofline.
