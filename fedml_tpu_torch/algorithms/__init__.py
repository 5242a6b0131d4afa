"""Round engine, aggregation and the FedAvg drive of the port."""
