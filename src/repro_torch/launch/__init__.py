# Command-line launchers of the LLM substrate: serve (prefill + greedy decode)
# and probe (analytical-CV permutation tests on layer representations).
