"""EDA examples of the port."""
