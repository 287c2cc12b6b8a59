"""Runtime pieces of the port: the training launcher (`train`), its FLOP
model (`flops`, `shapes`) and the fault-tolerance primitives it shares
with the serving stack (`fault_tolerance`)."""
