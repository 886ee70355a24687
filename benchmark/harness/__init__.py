"""The harness's own code: the cell's files, the traffic generators, the
trace reduction, the roofline table and the result line."""
