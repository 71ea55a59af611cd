"""The paper's arithmetic and analysis (the port of ``repro/core``): the LOA
adder, the FPGA ALM and VPU-op cost model, the SCM weight census, the DHM
(Direct Hardware Mapping) analyzer of Table 1 and the error metrics."""
