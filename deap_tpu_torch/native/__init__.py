"""Native host-side components of the port: the exact hypervolume sweep
(``hv.cpp``, plain C++ with a C ABI), built at first use by the host
compiler and bound with ``ctypes``."""
