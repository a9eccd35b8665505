"""FA math (Beta MLE, Gram-space solver) and the attack library."""
