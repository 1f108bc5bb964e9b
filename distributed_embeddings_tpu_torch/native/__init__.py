"""The port's native (C++) host library, loaded through ctypes.

``hashmap.cpp``, ``io.cpp`` and ``host_apply.cpp`` are copies of the JAX
package's sources; `loader` compiles them with g++ at first use into
``build/torch_ext/`` and raises when it cannot.
"""
