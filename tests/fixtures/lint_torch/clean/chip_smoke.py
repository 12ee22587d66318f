import torch

print(torch.__version__)
