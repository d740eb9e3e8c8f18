"""The benchmark's own machinery: the cell's files, the traffic
generator, the weights, the driver, the trace reduction, the roofline
count and the correctness check."""
