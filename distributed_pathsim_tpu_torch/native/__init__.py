"""Native host code of the port: the C++ GEXF parse + encode
(``gexf_fast.cpp``) and the C++ COO SpGEMM of the half-chain fold
(``coo_fast.cpp``), each built lazily with g++ into ``_build/`` and bound
through a plain C ABI and ``ctypes`` (:mod:`.build`). Every caller
degrades to the Python pipeline when no toolchain is present."""
