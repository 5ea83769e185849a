"""Program transformation: partitioning and the DistributedProgram."""
