"""Model/workload configurations of the port."""
