"""The plain reference of the benchmark's train steps.

Plain PyTorch only: it imports nothing of the program under test, of the JAX
package or of JAX, and takes nothing the program made. From the weights and
batches the harness makes it works out for itself what the program derives
from a batch (segment ids, positions, advantages, V-trace targets) and
follows the program's first updates step by step (:mod:`.step`).
"""
