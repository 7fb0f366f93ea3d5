"""The plain references of the benchmark's configurations, in plain
PyTorch. They import nothing of the program under test and take none of
its state: the harness makes the weights and inputs and hands the same
tensors to both sides."""
