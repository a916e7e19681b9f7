"""Plain references that decide ``correct``: PyTorch operations only, written
from the method's definition.  They import neither JAX, the JAX package nor
the port, and take nothing the program made: the harness hands them the
same inputs it handed the program (cores, targets, data, masks) and they
work every derived quantity out again.

- ``sgdg``: Stiefel SGD with momentum and the Cayley transform (SGD-G, Li,
  Li and Todorovic, ICLR 2020), with its rare QR retraction;
- ``brick``: the masked brick-wall circuit as a dense operator, its network
  fidelity against a target network and the fit's steps;
- ``born``: the Hermite feature map, the MPS Born-rule probability, the
  NLL loss and the trainer's steps.
"""
